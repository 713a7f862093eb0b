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
``(batch, context_length)`` int32 array (:func:`tokenize_batch`). A row whose
text is printable ASCII (tabs and line breaks allowed) without ``&`` needs no
cleaning, and is encoded by the C++ BPE of ``csrc/bpe.cpp`` (:class:`NativeBpe`,
built at first use by ``ops/_build.host_library``), called through ``ctypes``
with the interpreter lock released, so a thread that tokenizes does not stall
one that launches the towers. Every other row, and every row where no C++
compiler is found, takes the Python BPE of :class:`ClipBpeTokenizer`, whose
ids the C++ one reproduces; there an LRU cache at the string level keeps
repeated prompts out of profiles.
"""

from __future__ import annotations

import ctypes
import functools
import gzip
import html
import os
import threading
import unicodedata
import weakref
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from lemon_tpu_torch.core import profiling

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
_UNBUILT = object()  # a tokenizer's C++ BPE before its first use


def bpe_merge(parts: List[str], ranks: dict) -> tuple:
    """Byte-pair merges of one pre-token's symbols: while some adjacent pair
    has a rank, merge every occurrence of the first lowest-ranked pair, left
    to right; returns the symbol tuple."""
    while len(parts) > 1:
        ranked = [(ranks.get((parts[i], parts[i + 1])), i) for i in range(len(parts) - 1)]
        ranked = [(r, i) for r, i in ranked if r is not None]
        if not ranked:
            break
        _, best = min(ranked)  # the lowest rank, first in the word
        first, second = parts[best], parts[best + 1]
        merged: List[str] = []
        i = 0
        while i < len(parts):
            if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                merged.append(first + second)
                i += 2
            else:
                merged.append(parts[i])
                i += 1
        parts = merged
    return tuple(parts)


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
        self._native = _UNBUILT
        self._native_lock = threading.Lock()

    def native(self) -> Optional["NativeBpe"]:
        """The C++ BPE over this tokenizer's tables, made at first use; None
        where no C++ compiler is found."""
        with self._native_lock:
            if self._native is _UNBUILT:
                from lemon_tpu_torch.ops._build import host_library

                lib = host_library(NATIVE_SOURCE)
                self._native = NativeBpe(lib, self) if lib is not None else None
        return self._native

    @functools.lru_cache(maxsize=65536)
    def _bpe_word(self, word: str) -> tuple:
        """Apply BPE merges to one pre-token; returns the symbol tuple."""
        if word in (SOT_TEXT, EOT_TEXT):
            return (word,)
        return bpe_merge(list(word[:-1]) + [word[-1] + "</w>"], self.merge_rank)

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


NATIVE_SOURCE = Path(__file__).resolve().parent / "csrc" / "bpe.cpp"
_NATIVE_SIGNATURES = {
    # symbols (512), merges (n, 4), n, sot, eot -> handle
    "lemon_bpe_load": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32],
                       ctypes.c_void_p),
    "lemon_bpe_free": ([ctypes.c_void_p], None),
    # handle, data, offsets (rows + 1), rows, context, fill, out (rows, context), eligible (rows) -> eligible rows
    "lemon_bpe_encode_batch": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int64),
}


class NativeBpe:
    """The C++ BPE (``csrc/bpe.cpp``) over one :class:`ClipBpeTokenizer`'s
    tables: the symbol ids of each byte and of its ``</w>`` form, and every
    merge as (left id, right id, rank, merged id), all read from the
    tokenizer's ``token_to_id`` and ``merge_rank``. It encodes the rows that
    need no cleaning and says which those were."""

    def __init__(self, lib: ctypes.CDLL, tok: ClipBpeTokenizer):
        for name, (argtypes, restype) in _NATIVE_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        ids = tok.token_to_id
        symbols = [tok.byte_to_uni[b] for b in range(256)]
        table = np.array([ids[s] for s in symbols] + [ids[s + "</w>"] for s in symbols], np.int32)
        merges = np.array([(ids[a], ids[b], rank, ids[a + b]) for (a, b), rank in tok.merge_rank.items()],
                          np.int32).reshape(-1, 4)
        handle = lib.lemon_bpe_load(table.ctypes.data, merges.ctypes.data, len(merges), tok.sot_id, tok.eot_id)
        if not handle:
            raise MemoryError("lemon_bpe_load")
        self._handle = handle
        self._encode = lib.lemon_bpe_encode_batch
        weakref.finalize(self, lib.lemon_bpe_free, handle)

    def encode(self, texts: Sequence[str], context_length: int, fill: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(out, eligible)``: ``out`` (len(texts), context_length) int32
        holds each eligible row's ids as :func:`tokenize_batch` gives them and
        ``fill`` elsewhere; ``eligible`` (bool) marks the rows encoded here.
        A row that is not a ``str`` is not eligible."""
        if context_length < 1:
            raise ValueError(f"context_length {context_length} < 1")
        blobs = [t.encode("utf-8", "surrogatepass") if isinstance(t, str) else b"\0" for t in texts]
        offsets = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        out = np.empty((len(blobs), context_length), np.int32)
        eligible = np.empty(len(blobs), np.uint8)
        self._encode(self._handle, b"".join(blobs), offsets.ctypes.data, len(blobs), context_length, fill,
                     out.ctypes.data, eligible.ctypes.data)
        return out, eligible.astype(bool)


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

    Rows that need no cleaning go to the C++ BPE (:class:`NativeBpe`), the
    rest to the Python one, in the same array; under a profiler session the
    open span counts them (``native_rows``, ``python_rows``).
    """
    tok = tokenizer or get_tokenizer()
    texts = list(texts)
    fill = 0 if pad_mode == "zeros" else tok.eot_id
    native = tok.native()
    if native is not None:
        out, eligible = native.encode(texts, context_length, fill)
        rows = np.flatnonzero(~eligible).tolist()
    else:
        out = np.full((len(texts), context_length), fill, dtype=np.int32)
        rows = range(len(texts))
    profiling.count("native_rows", len(texts) - len(rows))
    profiling.count("python_rows", len(rows))
    for row in rows:
        ids = [tok.sot_id] + tok.encode(texts[row]) + [tok.eot_id]
        if len(ids) > context_length:
            ids = ids[: context_length - 1] + [tok.eot_id]
        out[row, : len(ids)] = ids
    return out

