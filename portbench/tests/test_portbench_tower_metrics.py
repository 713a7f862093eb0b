"""``tower_mfu`` and ``text_pad_share`` on hand-built records, each against
its value worked out by hand; None where a run has nothing for them: no
spans, no span recorder, tower spans without the counts, no trace."""

import types

import pytest

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.core.profiling import Span
from portbench import harness
from portbench.arch import openai_clip
from portbench.metrics import text_pad_share, tower_mfu
from portbench.roofline import PEAK_FLOPS
from portbench.tests.tiny import TINY


def _span(name, a, b, **counts):
    return Span(name, a * 7 + b, 1, "MainThread", a, b, counts)


# ns; the window (0, 10000) less the data making (0, 1000); the embed phase (1000, 7000)
SPANS = [
    Span("embed_compr", 1, None, "MainThread", 1_000, 7_000, {}),
    Span("hparam_scipy", 2, None, "MainThread", 7_000, 10_000, {}),
    _span("embed.images", -5_000, -4_000, image_rows=999),  # before the window
    _span("embed.images", 2_000, 3_000, h2d_bytes=1, image_rows=4),
    _span("embed.texts", 3_000, 3_500, h2d_bytes=1, text_rows=4, positions=4 * 16, eot_positions=5 + 6 + 7 + 7),
    _span("embed.images", 4_000, 5_000, image_rows=2),
    _span("embed.texts", 5_000, 5_500, text_rows=2, positions=2 * 16, eot_positions=16 + 3),
    _span("embed.texts", 8_000, 8_500, text_rows=9, positions=9 * 16, eot_positions=9),  # outside the embed phases
]
EVENTS = [
    ("Memcpy HtoD (Pageable -> Device)", 2_100, 2_600),  # a copy: not the towers' work
    ("ampere_bf16_gemm", 2_500, 3_200),
    ("softmax_kernel", 3_100, 3_300),  # overlaps the kernel before: counted once
    ("Memset (Device)", 3_300, 3_400),
    ("elementwise_kernel", 5_000, 5_600),
    ("k1_kernel", 7_000, 8_000),  # outside the embed phases
]
TEXTS = {"train": ["a dog", "a red car"], "val": ["two cats on a mat"], "test": ["x"]}


def _record(events=EVENTS):
    cfg = dict(TINY, precision="bf16")
    splits = {n: types.SimpleNamespace(texts=t) for n, t in TEXTS.items()}
    det = types.SimpleNamespace(pairs=4, splits=splits)
    cell = types.SimpleNamespace(config=cfg, mix={"kind": "captions"})
    return harness.Record(cell=cell, setup_s=0.0, window_s=9e-6, window_ns=(0, 10_000), made_ns=[(0, 1_000)],
                          detections=[det], failed=0, phases={}, spans=[], peak_bytes=0, device_events=events)


def test_tower_mfu_is_the_towers_flops_over_their_kernels_time(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    cfg = dict(TINY, precision="bf16")
    lengths = openai_clip.text_lengths([t for texts in TEXTS.values() for t in texts], cfg)
    text = sum(openai_clip.text_flops(cfg, n) for n in lengths) / len(lengths) * (4 + 2)
    flops = (4 + 2) * openai_clip.image_flops(cfg) + text
    kernel_s = ((3_300 - 2_500) + (5_600 - 5_000)) / 1e9
    assert tower_mfu.read(_record()) == pytest.approx(100 * flops / kernel_s / PEAK_FLOPS["bf16"], rel=1e-12)


def test_text_pad_share_is_the_positions_after_each_first_eot(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    want = 100 * (1 - (5 + 6 + 7 + 7 + 16 + 3) / (6 * 16))
    assert text_pad_share.read(_record()) == pytest.approx(want, rel=1e-12)


def test_both_are_none_without_spans_counts_or_trace(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert tower_mfu.read(_record()) is None and text_pad_share.read(_record()) is None
    uncounted = [s._replace(counts={k: v for k, v in s.counts.items() if k == "h2d_bytes"}) for s in SPANS]
    monkeypatch.setattr(profiling, "spans", lambda: uncounted)  # a program without the counters
    assert tower_mfu.read(_record()) is None and text_pad_share.read(_record()) is None
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert tower_mfu.read(_record(events=None)) is None  # an untraced run
    assert tower_mfu.read(_record(events=[e for e in EVENTS if e[0].startswith("Mem")])) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the span recorder
    assert tower_mfu.read(_record()) is None and text_pad_share.read(_record()) is None
