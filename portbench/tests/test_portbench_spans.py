"""The six span metrics on a hand-built record, each against its value
worked out by hand; None where a run has nothing for them; and on the card,
that a span and the device trace share one clock (``cuda``)."""

import types

import pytest
import torch

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.core.profiling import Span
from portbench import harness
from portbench.metrics import (
    device_idle_share,
    embed_dispatch_ms_per_1k_pairs,
    embed_h2d_gb_per_s,
    embed_wait_ms_per_1k_pairs,
    idle_dispatch_share,
    idle_prefetch_wait_share,
    tokenize_ms_per_1k_pairs,
)

READERS = (embed_wait_ms_per_1k_pairs, embed_dispatch_ms_per_1k_pairs, tokenize_ms_per_1k_pairs,
           idle_prefetch_wait_share, idle_dispatch_share, embed_h2d_gb_per_s)
H2D = "Memcpy HtoD (Pageable -> Device)"


def _span(name, a, b, thread="MainThread", parent=1, **counts):
    return Span(name, a * 7 + b, parent, thread, a, b, counts)


# ns; the window (0, 10000) less the data making (0, 1000): 9000 ns measured
SPANS = [
    Span("embed_compr", 1, None, "MainThread", 1_000, 7_000, {}),
    Span("hparam_scipy", 2, None, "MainThread", 7_000, 10_000, {}),
    _span("prefetch.wait", -5_000, -4_000),  # before the window
    _span("prefetch.wait", 1_000, 2_000),
    _span("embed.tokenize", 1_000, 1_800, thread="prefetch", texts=128),
    _span("embed.images", 2_000, 3_000, h2d_bytes=3_000),
    _span("embed.texts", 3_000, 3_500, h2d_bytes=1_000),
    _span("embed.tokenize", 3_000, 4_800, thread="prefetch", texts=128),
    _span("prefetch.wait", 3_500, 5_000),
    _span("embed.images", 5_000, 6_000, h2d_bytes=3_000),
    _span("embed.texts", 6_000, 6_500, h2d_bytes=1_000),
    _span("prefetch.wait", 6_500, 6_600),
    _span("embed.texts", 8_000, 8_500, parent=2, h2d_bytes=500),  # outside the embed phases
]
EVENTS = [(H2D, 2_100, 2_200), ("gemm", 2_200, 3_300), ("gemm", 3_400, 4_000), (H2D, 5_100, 5_300),
          ("gemm", 5_300, 6_800), ("gemm", 7_000, 7_500), ("gemm", 8_200, 8_300)]
# idle: (1000, 2100) (3300, 3400) (4000, 5100) (6800, 7000) (7500, 8200) (8300, 10000)
EXPECTED = {
    embed_wait_ms_per_1k_pairs: (1_000 + 1_500 + 100) / 1e6 / 2,  # ms per 1000 of 2000 pairs
    embed_dispatch_ms_per_1k_pairs: (1_000 + 500 + 1_000 + 500) / 1e6 / 2,
    tokenize_ms_per_1k_pairs: (800 + 1_800) / 1e6 / 2,
    # the gap (4000, 5100) straddles a wait and an image call: 1000 ns to the
    # wait and 100 to the call, where the midpoint rule would give all 1100 to the wait
    idle_prefetch_wait_share: 100 * (1_000 + 1_000) / 9_000,
    idle_dispatch_share: 100 * ((100 + 100) + 100 + (200 + 200)) / 9_000,
    embed_h2d_gb_per_s: 8_000 / (100 + 200),  # bytes per ns
}


def _record(events=EVENTS):
    return harness.Record(cell=None, setup_s=0.0, window_s=9e-6, window_ns=(0, 10_000), made_ns=[(0, 1_000)],
                          detections=[types.SimpleNamespace(pairs=2_000)], failed=0, phases={}, spans=[],
                          peak_bytes=0, device_events=events)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__.split(".")[-1])
def test_each_reader_gives_the_value_worked_out_by_hand(reader, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    rec = _record()
    assert reader.read(rec) == pytest.approx(EXPECTED[reader], rel=1e-12)
    waits, calls = idle_prefetch_wait_share.read(rec), idle_dispatch_share.read(rec)
    assert waits + calls <= device_idle_share.read(rec)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__.split(".")[-1])
def test_each_reader_gives_none_without_spans_or_trace(reader, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(_record()) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the span recorder
    assert reader.read(_record()) is None
    if reader.__name__.split(".")[-1] in ("idle_prefetch_wait_share", "idle_dispatch_share", "embed_h2d_gb_per_s"):
        monkeypatch.setattr(profiling, "spans", lambda: list(SPANS), raising=False)
        assert reader.read(_record(events=None)) is None


@pytest.mark.cuda
def test_a_span_contains_its_kernel_on_the_trace_clock(card):
    """Under the harness's own profiler session (device activity only), a
    span around a sleep kernel and a synchronise holds the kernel's
    interval in the trace."""
    profiling.reset()
    torch.cuda._sleep(1_000)
    torch.cuda.synchronize(card)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with profiling.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize(card)
    (sleep,) = [s for s in profiling.spans() if s.name == "sleep"]
    (kernel,) = [e for e in harness.device_events(prof) if "spin" in e[0]]
    assert sleep.start_ns <= kernel[1] < kernel[2] <= sleep.end_ns, (sleep, kernel)
