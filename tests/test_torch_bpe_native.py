"""The C++ BPE of ``lemon_tpu_torch/models/csrc/bpe.cpp`` against the Python
one of ``models/tokenizer.py``, id for id: reports, captions and prompts of
the benchmark's mixes, seeded random ASCII aimed at the pre-token pattern's
edges, empty rows, truncation in both pad modes, and a batch that mixes rows
the C++ BPE takes with rows it leaves to Python. Also that a call releases
the interpreter lock, that ``tokenize_batch`` counts the rows of each path
on the open span, and that without a compiler every row takes Python."""

import random
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.models import tokenizer as tk
from lemon_tpu_torch.ops import _build

TRAFFIC = Path(__file__).resolve().parents[1] / "portbench" / "traffic"


@pytest.fixture(scope="module")
def native_tok():
    if _build._cxx() is None:
        pytest.skip("no C++ compiler (c++) on PATH")
    tok = tk.get_tokenizer()
    assert tok.native() is not None
    return tok


@pytest.fixture(scope="module")
def python_tok():
    """A tokenizer whose rows all take the Python BPE: the oracle."""
    tok = tk.ClipBpeTokenizer()
    tok.native = lambda: None
    return tok


def _words(name):
    return (TRAFFIC / name).read_text().split()


def _captions(words, n, lo, hi, seed):
    rng = random.Random(seed)
    return [" ".join(rng.choice(words) for _ in range(rng.randint(lo, hi))) for _ in range(n)]


PIECES = ["'s", "'S", "..'s", "don't", "It'S", "'re", "'ve", "'m", "'ll", "'d", "'t", "''", "'x", "'", "'LL",
          "0", "7", "42", "2024", "0.5", "1,000", "!!!", "...", "?!", "-", "--", "()", "[]{}", "#$%", "~|\\", "\"",
          "<|startoftext|>", "<|endoftext|>", "<|endof", "<|start", "<|", "|>", ".<|startoftext|>",
          "x<|endoftext|>", "<|ENDOFTEXT|>", "<<|endoftext|>", "<|startoftext|><|endoftext|>",
          " ", "  ", "   ", "\t", "\n", "\r", "\r\n", " \t\n\r ",
          "a", "photo", "Chest", "X-RAY", "e.g.", "b2b", "x86_64", "__init__", "CamelCase", "lowercase"]


def _random_ascii(n, seed):
    """Strings of up to 40 pieces, each a piece above (weighted toward
    apostrophes, digits, punctuation, the special tokens and whitespace
    runs) or one random printable byte other than ``&``."""
    rng = random.Random(seed)
    printable = [chr(c) for c in range(0x20, 0x7F) if chr(c) != "&"]
    return ["".join(rng.choice(PIECES) if rng.random() < 0.7 else rng.choice(printable)
                    for _ in range(rng.randint(0, 40))) for _ in range(n)]


def _cifar100():
    return [f"a photo of a {label}" for label in (TRAFFIC / "labels_cifar100.txt").read_text().split()]


CASES = {
    "radiology_reports": lambda: _captions(_words("words_radiology.txt"), 300, 40, 180, seed=1),
    "long_reports": lambda: _captions(_words("words_radiology.txt"), 40, 250, 400, seed=2),  # past 256 tokens
    "flickr_captions": lambda: _captions(_words("words_flickr.txt"), 1_000, 8, 20, seed=3),
    "cifar100_prompts": _cifar100,
    "random_ascii": lambda: _random_ascii(5_000, seed=4),
    "empty_and_whitespace": lambda: ["", " ", "\t", "\n", "\r", "\r\n", " \t\n\r ", " " * 300, "\n" * 77, "a", " a "],
}


@pytest.mark.parametrize("pad_mode", ["zeros", "eot"])
@pytest.mark.parametrize("context_length", [77, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_rows_equal_the_python_bpe(case, context_length, pad_mode, native_tok, python_tok):
    texts = CASES[case]()
    fill = 0 if pad_mode == "zeros" else native_tok.eot_id
    _, eligible = native_tok.native().encode(texts, context_length, fill)
    assert eligible.all()  # every row of these cases takes the C++ BPE
    got = tk.tokenize_batch(texts, context_length, native_tok, pad_mode)
    want = tk.tokenize_batch(texts, context_length, python_tok, pad_mode)
    assert got.dtype == np.int32 and got.shape == (len(texts), context_length)
    np.testing.assert_array_equal(got, want)
    if case == "long_reports":  # every row cut, EOT forced last
        assert (got[:, -1] == native_tok.eot_id).all() and (got[:, -2] != native_tok.eot_id).all()


FALLBACK = ["café au lait", "東京 tower", "an emoji \U0001F600 here", "fish &amp; chips", "a & b",
            "vertical\x0btab", "unit\x1fsep", "form\x0cfeed", "nul\x00byte", "del\x7f", "nbsp\xa0here"]


def test_a_mixed_batch_keeps_its_rows_in_order(native_tok, python_tok):
    eligible_rows = _captions(_words("words_flickr.txt"), len(FALLBACK), 8, 20, seed=5)
    texts = [t for pair in zip(eligible_rows, FALLBACK) for t in pair] + ["tab\tand\r\nbreaks"]
    _, eligible = native_tok.native().encode(texts, 77, 0)
    np.testing.assert_array_equal(eligible, [i % 2 == 0 for i in range(len(texts) - 1)] + [True])
    for pad_mode in ("zeros", "eot"):
        got = tk.tokenize_batch(texts, 77, native_tok, pad_mode)
        np.testing.assert_array_equal(got, tk.tokenize_batch(texts, 77, python_tok, pad_mode))
    for i, text in enumerate(texts):  # each row alone, wherever it sat in the batch
        np.testing.assert_array_equal(got[i], tk.tokenize_batch([text], 77, python_tok, "eot")[0])


def test_the_rows_of_each_path_are_counted_on_the_open_span(native_tok):
    texts = ["a photo of a cat", "café", "fish &amp; chips", "two dogs", "x-ray"]
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("embed.tokenize"):
            tk.tokenize_batch(texts, 77, native_tok)
    (span,) = profiling.spans()
    assert span.counts == {"native_rows": 3, "python_rows": 2}
    profiling.reset()
    tk.tokenize_batch(texts, 77, native_tok)  # no session: nothing recorded
    assert profiling.spans() == []


def test_without_a_compiler_every_row_takes_python(monkeypatch, python_tok):
    monkeypatch.setattr(_build, "host_library", lambda source: None)
    tok = tk.ClipBpeTokenizer()
    assert tok.native() is None
    texts = CASES["flickr_captions"]()[:50] + FALLBACK
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("embed.tokenize"):
            got = tk.tokenize_batch(texts, 77, tok)
    assert profiling.spans()[0].counts == {"native_rows": 0, "python_rows": len(texts)}
    np.testing.assert_array_equal(got, tk.tokenize_batch(texts, 77, python_tok))
    profiling.reset()


def test_the_native_call_releases_the_interpreter_lock(native_tok):
    """A second thread runs Python while one ``encode`` of 20,000 reports
    is inside the C++ call. The switch interval is set far above the call's
    length, so the calling thread yields the lock only where it blocks or
    leaves it in native code: the counting thread, released by an Event set
    just before the call, can only start while the call runs if the call
    released the lock; held, it would start after the call, Event cleared."""
    native = native_tok.native()
    reports = _captions(_words("words_radiology.txt"), 20_000, 40, 180, seed=6)
    real = native._encode
    inside = threading.Event()
    seen = {}

    def call(*args):
        inside.set()
        try:
            return real(*args)
        finally:
            inside.clear()

    def count():
        inside.wait(timeout=120)
        seen["inside_at_start"] = inside.is_set()
        n = 0
        while n < 200_000:  # bounded: the caller waits for the lock until this thread ends
            n += 1
        seen["counter"] = n

    native._encode = call
    interval = sys.getswitchinterval()
    counter = threading.Thread(target=count, name="counter")
    counter.start()
    try:
        sys.setswitchinterval(1_000.0)
        out, eligible = native.encode(reports, 256, 0)
    finally:
        sys.setswitchinterval(interval)
        native._encode = real
        counter.join(timeout=120)
    assert not counter.is_alive()
    assert seen == {"inside_at_start": True, "counter": 200_000}
    assert eligible.all() and (out[:, 0] == native_tok.sot_id).all()


def test_the_word_cache_clears_past_its_bound_and_stays_right(python_tok):
    """1.1M distinct pre-tokens overflow a handle's cache of 1M; the ids of a
    batch seen before the overflow are the same after it."""
    if _build._cxx() is None:
        pytest.skip("no C++ compiler (c++) on PATH")
    native = tk.NativeBpe(_build.host_library(tk.NATIVE_SOURCE), python_tok)  # a handle of its own
    texts = _captions(_words("words_radiology.txt"), 200, 40, 180, seed=8)
    want = tk.tokenize_batch(texts, 256, python_tok)
    np.testing.assert_array_equal(native.encode(texts, 256, 0)[0], want)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(w) for w in letters[np.indices((26,) * 5).reshape(5, -1).T[:1_100_000]]]  # distinct 5-letter runs
    flood = [" ".join(words[i:i + 1_000]) for i in range(0, len(words), 1_000)]
    _, eligible = native.encode(flood, 5_000, 0)  # wide enough that no row is cut short
    assert eligible.all()
    np.testing.assert_array_equal(native.encode(texts, 256, 0)[0], want)
