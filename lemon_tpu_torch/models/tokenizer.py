"""CLIP byte-pair-encoding tokenizer (the port's own copy of
lemon_tpu/models/tokenizer.py, so that the port imports nothing of the JAX
package).

The OpenAI CLIP BPE scheme (vocab size 49,408: 256 byte symbols + 256
``</w>`` byte symbols + 48,894 merges + SOT/EOT); token ids are
bit-identical to the JAX package's tokenizer and to HuggingFace's
``CLIPTokenizer``, which checkpoint parity needs.

The merge table is a public OpenAI data artifact, a byte-identical copy of
the JAX package's under ``lemon_tpu_torch/models/assets/``;
``LEMON_TPU_BPE_PATH`` overrides the path.

Tokenization runs on the host; the output is a fixed-shape
``(batch, context_length)`` int32 array (:func:`tokenize_batch`). Prompt-style
workloads re-tokenize the same few strings many times, so an LRU cache at the
string level keeps the tokenizer out of profiles.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import Iterable, List, Sequence

import numpy as np

try:
    import regex as _re  # supports \p{L} / \p{N} classes

    _HAS_REGEX = True
except ImportError:  # pragma: no cover
    import re as _re

    _HAS_REGEX = False

try:
    import ftfy as _ftfy

    if not hasattr(_ftfy, "fix_text"):  # a stubbed module is as good as none
        _ftfy = None
except ImportError:  # pragma: no cover
    _ftfy = None

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77


def default_vocab_path() -> str:
    env = os.environ.get("LEMON_TPU_BPE_PATH")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "bpe_simple_vocab_16e6.txt.gz")


@functools.lru_cache(maxsize=None)
def byte_unicode_table() -> dict:
    """Invertible byte -> printable-unicode-codepoint mapping.

    Printable latin bytes map to themselves; the remaining bytes are remapped
    to codepoints starting at 256 so the BPE operates on visible characters.
    """
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    # Insertion order defines vocabulary ids downstream: printable bytes first
    # (in their range order), then the remapped bytes in ascending byte order.
    table = {b: chr(b) for b in printable}
    fill = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + fill)
            fill += 1
    return table


if _HAS_REGEX:
    _WORD_PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
else:  # pragma: no cover - stdlib-re approximation (letters/digits classes)
    _WORD_PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|[\d]|[^\s\w]+""",
        _re.IGNORECASE,
    )

_WHITESPACE = _re.compile(r"\s+")


def _clean_text(text: str) -> str:
    """Unicode-normalize and unescape, collapse whitespace, lowercase later.

    The reference pipeline is ftfy.fix_text -> double html.unescape -> strip
    (simple_tokenizer.py:74-83). ftfy is optional here: for already-sane text
    (every prompt/caption in the supported datasets) fix_text is the identity,
    and when ftfy is importable we use it for full equivalence.
    """
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    else:
        text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = _WHITESPACE.sub(" ", text.strip())
    return text


class ClipBpeTokenizer:
    """Byte-pair encoder over the CLIP merge table.

    >>> tok = ClipBpeTokenizer()
    >>> tok.encode("a photo of a cat")
    [320, 1125, 539, 320, 2368]
    """

    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or default_vocab_path()
        self.byte_to_uni = byte_unicode_table()
        self.uni_to_byte = {v: k for k, v in self.byte_to_uni.items()}

        with gzip.open(vocab_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        # Line 0 is a header; entries beyond 48,894 merges are unused tail.
        n_merges = VOCAB_SIZE - 2 * 256 - 2
        merge_pairs = [tuple(line.split()) for line in lines[1 : n_merges + 1]]

        symbols = list(self.byte_to_uni.values())
        vocab: List[str] = symbols + [s + "</w>" for s in symbols]
        vocab.extend(a + b for a, b in merge_pairs)
        vocab.append(SOT_TEXT)
        vocab.append(EOT_TEXT)
        assert len(vocab) == VOCAB_SIZE, len(vocab)

        self.token_to_id = {tok: i for i, tok in enumerate(vocab)}
        self.id_to_token = vocab
        self.merge_rank = {pair: i for i, pair in enumerate(merge_pairs)}
        self.sot_id = self.token_to_id[SOT_TEXT]
        self.eot_id = self.token_to_id[EOT_TEXT]

    @functools.lru_cache(maxsize=65536)
    def _bpe_word(self, word: str) -> tuple:
        """Apply BPE merges to one pre-token; returns the symbol tuple."""
        if word in (SOT_TEXT, EOT_TEXT):
            return (word,)
        parts: List[str] = list(word[:-1]) + [word[-1] + "</w>"]
        if len(parts) == 1:
            return tuple(parts)
        while len(parts) > 1:
            # Find the lowest-rank adjacent pair currently present.
            ranked = [
                (self.merge_rank.get((parts[i], parts[i + 1]), None), i)
                for i in range(len(parts) - 1)
            ]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            best_rank = min(r for r, _ in ranked)
            best_pair = None
            for r, i in ranked:
                if r == best_rank:
                    best_pair = (parts[i], parts[i + 1])
                    break
            # Merge every occurrence of best_pair left-to-right.
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == best_pair[0]
                    and parts[i + 1] == best_pair[1]
                ):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return tuple(parts)

    @functools.lru_cache(maxsize=65536)
    def _encode_cached(self, text: str) -> tuple:
        ids: List[int] = []
        cleaned = _clean_text(text).lower()
        for match in _WORD_PATTERN.findall(cleaned):
            as_unicode = "".join(self.byte_to_uni[b] for b in match.encode("utf-8"))
            ids.extend(self.token_to_id[sym] for sym in self._bpe_word(as_unicode))
        return tuple(ids)

    def encode(self, text: str) -> List[int]:
        return list(self._encode_cached(text))

    def decode(self, ids: Iterable[int]) -> str:
        chars = "".join(self.id_to_token[i] for i in ids)
        raw = bytearray(self.uni_to_byte[c] for c in chars if c in self.uni_to_byte)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache(maxsize=4)
def get_tokenizer(vocab_path: str | None = None) -> ClipBpeTokenizer:
    return ClipBpeTokenizer(vocab_path)


def tokenize_batch(
    texts: Sequence[str],
    context_length: int = CONTEXT_LENGTH,
    tokenizer: ClipBpeTokenizer | None = None,
    pad_mode: str = "zeros",
) -> np.ndarray:
    """Tokenize a batch of strings to a fixed ``(B, context_length)`` array.

    ``pad_mode='zeros'`` matches the OpenAI/chexzero ``tokenize``
    (chexzero_clip.py:481-493): [SOT] + ids + [EOT] zero-padded, truncated
    with EOT forced at the last position. ``pad_mode='eot'`` matches the
    HuggingFace CLIP tokenizer's max-length padding (pad token == EOT).
    EOT pooling (argmax over ids) selects the same position in both modes
    because argmax returns the first occurrence of the max id.
    """
    tok = tokenizer or get_tokenizer()
    fill = 0 if pad_mode == "zeros" else tok.eot_id
    out = np.full((len(texts), context_length), fill, dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tok.sot_id] + tok.encode(text) + [tok.eot_id]
        if len(ids) > context_length:
            ids = ids[: context_length - 1] + [tok.eot_id]
        out[row, : len(ids)] = ids
    return out

