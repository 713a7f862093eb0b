"""BERT WordPiece tokenisation in plain Python (for ``biomed_clip``).

The JAX package tokenises BiomedCLIP's text with ``transformers``'
``BertTokenizerFast`` over a local PubMedBERT ``vocab.txt``
(lemon_tpu/models/biomed.py:141-151); the GPU machine has no
``transformers``, so this module re-states what that tokenizer does with
its defaults (lowercase, accents stripped, CJK characters split):

1. normalise: drop NUL, U+FFFD and control characters, map whitespace to a
   space, put spaces around CJK ideographs, strip accents (NFD, then drop
   nonspacing marks), lowercase;
2. split on whitespace, and make every punctuation character (ASCII
   punctuation or a Unicode ``P*`` category) a word of its own;
3. WordPiece each word: the longest vocabulary entry from the left, then
   ``##``-prefixed continuations; a word with no full cover, or longer than
   100 characters, becomes ``[UNK]``;
4. ``[CLS]`` + ids (truncated to ``context_length - 2``) + ``[SEP]``, padded
   with ``[PAD]`` to ``context_length`` (:meth:`WordPieceTokenizer.batch`:
   to the batch's longest row, with the attention mask, as ``padding=True,
   truncation=True`` pads).

``lowercase=False`` (``do_lower_case: false`` in a ``tokenizer_config.json``)
keeps case and accents, as the fast tokenizer does with ``strip_accents``
unset.

tests/test_torch_biomed.py holds it to ``BertTokenizerFast``.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

MAX_WORD_CHARS = 100
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F), (0x2B740, 0x2B81F),
               (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in "\t\n\r" or ch.isspace()


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def normalize(text: str, lowercase: bool = True) -> str:
    out = []
    for ch in text:
        if ord(ch) in (0, 0xFFFD) or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(ch):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    if not lowercase:
        return "".join(out)
    text = unicodedata.normalize("NFD", "".join(out))
    return "".join(ch for ch in text if unicodedata.category(ch) != "Mn").lower()


def pre_tokenize(text: str) -> List[str]:
    words = []
    for chunk in text.split():
        start = 0
        for i, ch in enumerate(chunk):
            if _is_punctuation(ch):
                if i > start:
                    words.append(chunk[start:i])
                words.append(ch)
                start = i + 1
        if start < len(chunk):
            words.append(chunk[start:])
    return words


class WordPieceTokenizer:
    """Token ids of a BERT vocabulary (one token a line; its id is the line
    number)."""

    def __init__(self, vocab_path, lowercase: bool = True):
        self.lowercase = lowercase
        lines = Path(vocab_path).read_text(encoding="utf-8").split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        self.vocab: Dict[str, int] = {tok: i for i, tok in enumerate(lines)}  # a repeated token: its last line
        for special in ("[UNK]", "[CLS]", "[SEP]", "[PAD]"):
            if special not in self.vocab:
                raise ValueError(f"{vocab_path}: no {special} in the vocabulary")
        self.unk, self.cls, self.sep, self.pad = (self.vocab[t] for t in ("[UNK]", "[CLS]", "[SEP]", "[PAD]"))

    def word_ids(self, word: str) -> List[int]:
        if len(word) > MAX_WORD_CHARS:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if end == start:
                return [self.unk]
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        return [i for word in pre_tokenize(normalize(text, self.lowercase)) for i in self.word_ids(word)]

    def __call__(self, texts: Sequence[str], context_length: int) -> np.ndarray:
        """(B, context_length) int32: ``[CLS] ids [SEP]``, truncated, padded."""
        out = np.full((len(texts), context_length), self.pad, np.int32)
        for r, text in enumerate(texts):
            ids = [self.cls, *self.encode(text)[: context_length - 2], self.sep]
            out[r, : len(ids)] = ids
        return out

    def batch(self, texts: Sequence[str], max_length: int) -> tuple[np.ndarray, np.ndarray]:
        """(ids, attention mask), int64 (B, L): each row ``[CLS] ids [SEP]``
        truncated to ``max_length``, padded to the batch's longest row."""
        rows = [[self.cls, *self.encode(t)[: max_length - 2], self.sep] for t in texts]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for r, row in enumerate(rows):
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        return ids, mask
