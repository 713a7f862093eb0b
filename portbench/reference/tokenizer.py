"""CLIP byte-pair-encoding tokenizer: the benchmark's frozen copy.

OpenAI CLIP's BPE (vocabulary 49,408: 256 byte symbols, 256 ``</w>`` byte
symbols, 48,894 merges, SOT and EOT), over the public merge table beside
this file. Rows are ``[SOT] + ids + [EOT]``, zero-padded to the context and
cut with EOT forced at the last position (OpenAI's ``tokenize``). The
reference tokenizes every text it embeds itself, so a change to the
program's tokenizer shows in the embeddings' comparison.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import List, Sequence

import numpy as np

try:
    import regex as _re

    _WORDS = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE)
except ImportError:  # the stdlib's classes: the same splits on ASCII text
    import re as _re

    _WORDS = _re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|[\d]|[^\s\w]+""",
                         _re.IGNORECASE)

VOCAB_SIZE = 49408
_VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")


def _byte_table() -> dict:
    printable = [*range(ord("!"), ord("~") + 1), *range(0xA1, 0xAC + 1), *range(0xAE, 0xFF + 1)]
    table = {b: chr(b) for b in printable}
    extra = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class Tokenizer:
    def __init__(self, vocab_path: str = _VOCAB):
        self.byte_to_uni = _byte_table()
        with gzip.open(vocab_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        merges = [tuple(line.split()) for line in lines[1: VOCAB_SIZE - 2 * 256 - 2 + 1]]
        symbols = list(self.byte_to_uni.values())
        vocab = symbols + [s + "</w>" for s in symbols] + [a + b for a, b in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        if len(vocab) != VOCAB_SIZE:
            raise ValueError(f"{vocab_path}: {len(vocab)} symbols, expected {VOCAB_SIZE}")
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.sot, self.eot = self.ids["<|startoftext|>"], self.ids["<|endoftext|>"]

    @functools.lru_cache(maxsize=None)
    def _word(self, word: str) -> tuple:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [(self.ranks[p], i) for i, p in enumerate(zip(parts, parts[1:])) if p in self.ranks]
            if not ranked:
                break
            first, second = parts[min(ranked)[1]], parts[min(ranked)[1] + 1]
            merged, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return tuple(parts)

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(unicodedata.normalize("NFC", text)))
        text = " ".join(text.split()).lower()
        out: List[int] = []
        for match in _WORDS.findall(text):
            word = "".join(self.byte_to_uni[b] for b in match.encode("utf-8"))
            out.extend(self.ids[s] for s in self._word(word))
        return out

    def __call__(self, texts: Sequence[str], context: int) -> np.ndarray:
        rows = np.zeros((len(texts), context), np.int64)
        for r, text in enumerate(texts):
            ids = [self.sot, *self.encode(text), self.eot]
            if len(ids) > context:
                ids = ids[: context - 1] + [self.eot]
            rows[r, : len(ids)] = ids
        return rows
