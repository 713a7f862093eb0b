"""OPT's tokenizer: GPT-2 byte-level BPE in plain Python.

What ``AutoTokenizer.from_pretrained`` builds for an OPT checkpoint
(``GPT2TokenizerFast``), re-stated for the GPU machine, which has no
``transformers`` (the JAX trainer's ``_hf_tokenizer``,
lemon_tpu/train/captioning.py:89-98):

1. split out the special tokens (BOS, EOS, PAD, UNK) as whole tokens;
2. pre-tokenise with GPT-2's regex (``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
   ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``);
3. map each piece's UTF-8 bytes through the byte-to-unicode table and merge
   by rank (``merges.txt``), the lowest-ranked adjacent pair first;
4. prepend BOS when ``tokenizer_config.json`` says ``add_bos_token`` (OPT
   does), truncate to ``max_length`` (BOS included) and pad on the right.

``decode`` joins the tokens, maps them back to bytes (invalid UTF-8
replaced) and, with ``clean_up_tokenization_spaces``, applies HF's clean-up.
The vocabulary comes from ``vocab.json`` + ``merges.txt`` or from a
``tokenizer.json``. tests/test_torch_gpt2_bpe.py holds it to
``GPT2TokenizerFast``.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import regex

from lemon_tpu_torch.models.tokenizer import bpe_merge, byte_unicode_table

PATTERN = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json")


def _clean_up(text: str) -> str:
    """HF's ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _token(value) -> Optional[str]:
    """A special token as ``tokenizer_config.json`` writes it: a string or
    an AddedToken dict."""
    return value.get("content") if isinstance(value, dict) else value


class GPT2BPETokenizer:
    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], bos_token: str = "<|endoftext|>",
                 eos_token: str = "<|endoftext|>", pad_token: Optional[str] = None,
                 unk_token: Optional[str] = "<|endoftext|>", add_bos_token: bool = False,
                 clean_up_tokenization_spaces: bool = False):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(pair): r for r, pair in enumerate(merges)}
        self.byte_to_uni = byte_unicode_table()
        self.uni_to_byte = {u: b for b, u in self.byte_to_uni.items()}
        self.bos_token, self.eos_token, self.pad_token, self.unk_token = bos_token, eos_token, pad_token, unk_token
        self.bos_id = self.vocab[bos_token]
        self.eos_id = self.vocab[eos_token]
        self.pad_id = self.vocab[pad_token] if pad_token is not None else None
        self.add_bos_token = add_bos_token
        self.clean_up_tokenization_spaces = clean_up_tokenization_spaces
        specials = sorted({t for t in (bos_token, eos_token, pad_token, unk_token) if t is not None}, key=len,
                          reverse=True)
        self._special = regex.compile("(" + "|".join(regex.escape(t) for t in specials) + ")")
        self._specials = set(specials)

    @staticmethod
    def from_dir(path) -> "GPT2BPETokenizer":
        d = Path(path)
        cfg_path = d / "tokenizer_config.json"
        cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
        if (d / "vocab.json").exists() and (d / "merges.txt").exists():
            vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
            lines = (d / "merges.txt").read_text(encoding="utf-8").split("\n")
            merges = [tuple(line.split(" ")) for line in lines if line and not line.startswith("#version")]
        elif (d / "tokenizer.json").exists():
            model = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))["model"]
            if model.get("type") != "BPE":
                raise ValueError(f"{d}/tokenizer.json holds a {model.get('type')} model, not byte-level BPE")
            vocab = model["vocab"]
            merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
        else:
            raise FileNotFoundError(f"{d}: no vocab.json + merges.txt or tokenizer.json")
        kw = {k: _token(cfg[k]) for k in ("bos_token", "eos_token", "pad_token", "unk_token") if k in cfg}
        return GPT2BPETokenizer(vocab, merges, add_bos_token=bool(cfg.get("add_bos_token", False)),
                                clean_up_tokenization_spaces=bool(cfg.get("clean_up_tokenization_spaces", False)),
                                **kw)

    @functools.lru_cache(maxsize=65536)
    def _bpe(self, piece: str) -> Tuple[str, ...]:
        return bpe_merge(list(piece), self.ranks)

    def encode(self, text: str) -> List[int]:
        """Ids of ``text`` without BOS."""
        ids = []
        for chunk in self._special.split(text):
            if not chunk:
                continue
            if chunk in self._specials:
                ids.append(self.vocab[chunk])
                continue
            for piece in PATTERN.findall(chunk):
                mapped = "".join(self.byte_to_uni[b] for b in piece.encode("utf-8"))
                for sym in self._bpe(mapped):
                    if sym in self.vocab:
                        ids.append(self.vocab[sym])
                    elif self.unk_token is not None:
                        ids.append(self.vocab[self.unk_token])
        return ids

    def __call__(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, attention mask), int64 (B, max_length): ``padding="max_length",
        truncation=True``."""
        if self.pad_id is None:
            raise ValueError("padding needs a pad_token")
        ids = np.full((len(texts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            row = ([self.bos_id] if self.add_bos_token else []) + self.encode(text)
            row = row[:max_length]
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.id_to_token[int(i)] for i in ids)
        raw = bytearray()
        for ch in text:
            if ch in self.uni_to_byte:
                raw.append(self.uni_to_byte[ch])
            else:
                raw.extend(ch.encode("utf-8"))
        out = raw.decode("utf-8", errors="replace")
        return _clean_up(out) if self.clean_up_tokenization_spaces else out
