"""``tokenize_native_share`` on a hand-built record, against its value worked
out by hand, and None where a run has nothing for it: no spans, no span
recorder, or tokenize spans without the row counts."""

import types

import pytest

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.core.profiling import Span
from portbench import harness
from portbench.metrics import tokenize_native_share


def _tokenize(a, b, **counts):
    return Span("embed.tokenize", a * 7 + b, 1, "prefetch", a, b, counts)


# ns; the window (0, 10000) less the data making (0, 1000), the embed phase (1000, 7000)
SPANS = [
    Span("embed_compr", 1, None, "MainThread", 1_000, 7_000, {}),
    Span("hparam_scipy", 2, None, "MainThread", 7_000, 10_000, {}),
    _tokenize(-5_000, -4_000, native_rows=0, python_rows=128),  # before the window
    _tokenize(500, 1_200, native_rows=128, python_rows=0),  # begins in the data making, ends in the phase
    _tokenize(1_500, 2_000, native_rows=120, python_rows=8),
    _tokenize(3_000, 3_400, native_rows=0, python_rows=128),
    _tokenize(8_000, 8_500, native_rows=0, python_rows=128),  # outside the embed phases
]


def _record():
    return harness.Record(cell=None, setup_s=0.0, window_s=9e-6, window_ns=(0, 10_000), made_ns=[(0, 1_000)],
                          detections=[types.SimpleNamespace(pairs=2_000)], failed=0, phases={}, spans=[],
                          peak_bytes=0, device_events=None)


def test_the_share_is_the_native_rows_over_all_rows_in_the_embed_phases(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert tokenize_native_share.read(_record()) == pytest.approx(100 * (128 + 120) / (128 + 128 + 128), rel=1e-12)


def test_the_share_is_none_without_spans_or_counts(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert tokenize_native_share.read(_record()) is None
    uncounted = [s._replace(counts={}) if s.name == "embed.tokenize" else s for s in SPANS]  # a program without them
    monkeypatch.setattr(profiling, "spans", lambda: uncounted)
    assert tokenize_native_share.read(_record()) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the span recorder
    assert tokenize_native_share.read(_record()) is None
