"""The span recorder of ``lemon_tpu_torch.core.profiling`` at the embed
layer's boundaries: what ``ClipEncoder.embed_split`` records under a
profiler session and without one, the bytes it counts, the clock it shares
with the profiler, and that a span touches no device."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.core.profiling import PhaseTimer
from lemon_tpu_torch.data.datasets import ClassificationSplit
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel, init_weights
from lemon_tpu_torch.models.encoder import ClipEncoder
from lemon_tpu_torch.ops.image import resize_matrix

CPU = torch.device("cpu")
ROWS, BATCH, SIDE = 40, 16, 40  # three batches, the last padded; 40 px images resized to the tiny 32
EMBED_SPANS = ("prefetch.wait", "embed.images", "embed.texts", "embed.tokenize")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def encoder():
    return ClipEncoder(init_weights(ClipModel(ClipConfig.tiny()), seed=0), CPU, batch_size=BATCH)


def _split():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 5, ROWS)
    images = rng.integers(0, 256, (ROWS, SIDE, SIDE, 3), dtype=np.uint8)
    return ClassificationSplit(y_clean=y, y_noisy=y, images=images), [f"a photo of thing {i}" for i in y]


def _embed(encoder, profiled: bool):
    split, texts = _split()
    profiling.reset()
    timer = PhaseTimer(CPU)
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with timer.phase("embed_val"):
                encoder.embed_split(split, texts)
    else:
        prof = None
        with timer.phase("embed_val"):
            encoder.embed_split(split, texts)
    return profiling.spans(), prof


def test_no_session_records_nothing(encoder):
    spans, _ = _embed(encoder, profiled=False)
    assert spans == []


def test_embed_split_spans_and_parents(encoder):
    spans, _ = _embed(encoder, profiled=True)
    (phase,) = [s for s in spans if s.name == "embed_val"]
    assert phase.parent is None and phase.thread == threading.current_thread().name
    batches = -(-ROWS // BATCH)
    by_name = {n: [s for s in spans if s.name == n] for n in EMBED_SPANS}
    # one wait a batch, and one more for the worker's end-of-items marker
    assert {n: len(v) for n, v in by_name.items()} == {"prefetch.wait": batches + 1, "embed.images": batches,
                                                       "embed.texts": batches, "embed.tokenize": batches}
    for name, group in by_name.items():
        want_thread = "prefetch" if name == "embed.tokenize" else threading.current_thread().name
        for s in group:
            assert s.parent == phase.id and s.thread == want_thread
            assert phase.start_ns <= s.start_ns <= s.end_ns <= phase.end_ns
    # each batch's rows, padded to the batch size, counted once: by the C++ BPE or the Python one
    tokenized = [s.counts["native_rows"] + s.counts["python_rows"] for s in by_name["embed.tokenize"]]
    assert tokenized == [BATCH] * batches and all(set(s.counts) == {"native_rows", "python_rows"}
                                                  for s in by_name["embed.tokenize"])
    assert len({s.id for s in spans}) == len(spans)


def test_h2d_bytes_are_the_bytes_handed_to_the_device(encoder, monkeypatch):
    handed = []
    to = torch.Tensor.to

    def spy(self, *args, **kwargs):  # every host tensor moved to the encoder's device
        if self.device.type == "cpu" and any(isinstance(a, torch.device) for a in (*args, *kwargs.values())):
            handed.append(self.nbytes)
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    spans, _ = _embed(encoder, profiled=True)
    images = [s.counts["h2d_bytes"] for s in spans if s.name == "embed.images"]
    texts = [s.counts["h2d_bytes"] for s in spans if s.name == "embed.texts"]
    per_image_batch = BATCH * SIDE * SIDE * 3 + 2 * resize_matrix(SIDE, 32).nbytes + 2 * 3 * 4  # pixels, A_h, A_w, mean, std
    per_text_batch = [BATCH * n * 4 for n in _longest_pooled(encoder)]  # int32 tokens, cut to the longest EOT
    assert images == [per_image_batch] * len(images) and texts == per_text_batch
    assert sum(images) + sum(texts) == sum(handed)


def test_spans_share_the_profilers_clock(encoder):
    spans, prof = _embed(encoder, profiled=True)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e.start_ns())
    for name in ("embed_val", "embed.images", "embed.texts", "prefetch.wait"):
        starts = sorted(s.start_ns for s in spans if s.name == name)
        assert len(events[name]) == len(starts)
        assert max(abs(a - b) for a, b in zip(sorted(events[name]), starts)) < 1_000_000


def test_spans_touch_no_device(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span touched the device")

    for owner, attr in ((torch.cuda, "synchronize"), (torch.cuda.Stream, "synchronize"),
                        (torch.cuda.Event, "synchronize"), (torch.Tensor, "to"), (torch.Tensor, "cpu"),
                        (torch.Tensor, "copy_"), (torch.Tensor, "item")):
        monkeypatch.setattr(owner, attr, refuse)
    profiling.reset()
    for profiled in (False, True):
        session = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        with session if profiled else contextlib.nullcontext():
            with profiling.span("outer", n=1) as outer:
                profiling.count("n", 2)
                context = profiling.handoff()
                worker = threading.Thread(target=lambda: (profiling.adopt(context), _inner()), name="w")
                worker.start()
                worker.join(timeout=10)
                assert not worker.is_alive()
        recorded = profiling.spans()
        if not profiled:
            assert recorded == [] and context is None
    outer_span, inner = next(s for s in recorded if s.name == "outer"), next(s for s in recorded if s.name == "inner")
    assert outer_span.counts == {"n": 3} and outer_span.id == outer.id
    assert inner.parent == outer_span.id and inner.thread == "w"


def _inner():
    with profiling.span("inner"):
        time.sleep(0.001)


def _pooled_positions(encoder):
    """Each row's first EOT position plus one, from the BPE's own lengths,
    batch by batch, the tail's padding rows included."""
    _, texts = _split()
    ctx, batches = encoder.cfg.context_length, -(-ROWS // BATCH)
    eot = [min(len(encoder.tokenizer.encode(texts[min(i, ROWS - 1)])) + 2, ctx) for i in range(batches * BATCH)]
    return [eot[b * BATCH:(b + 1) * BATCH] for b in range(batches)]


def _longest_pooled(encoder):
    """The positions the text tower runs a batch to: its longest EOT."""
    return [max(batch) for batch in _pooled_positions(encoder)]


def test_tower_spans_count_rows_and_positions(encoder):
    """``image_rows`` and ``text_rows``: each batch's rows, the tail's padding
    included; ``positions``: rows x the batch's longest pooled position, the
    length the text tower ran; ``eot_positions``: each row's first EOT
    position plus one, from the BPE's own lengths."""
    spans, _ = _embed(encoder, profiled=True)
    batches = -(-ROWS // BATCH)
    images = [s.counts for s in spans if s.name == "embed.images"]
    text_spans = [s.counts for s in spans if s.name == "embed.texts"]
    assert [c["image_rows"] for c in images] == [BATCH] * batches
    assert [c["text_rows"] for c in text_spans] == [BATCH] * batches
    assert [c["positions"] for c in text_spans] == [BATCH * n for n in _longest_pooled(encoder)]
    assert all(n < encoder.cfg.context_length for n in _longest_pooled(encoder))  # the cut engaged
    assert [c["eot_positions"] for c in text_spans] == [sum(batch) for batch in _pooled_positions(encoder)]


def test_cached_rows_and_unrecorded_runs_count_nothing(encoder, tmp_path):
    """A split read from the ``.npz`` cache runs no tower and counts no row;
    without a profiler session nothing is counted and no span is open."""
    split, texts = _split()
    key = encoder.cache_key(split, texts)
    profiling.reset()
    encoder.embed_split(split, texts, cache_key=key, cache_dir=tmp_path)  # fills the cache, unrecorded
    assert profiling.spans() == [] and not profiling.counting()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with PhaseTimer(CPU).phase("embed_val"):
            assert profiling.counting()
            encoder.embed_split(split, texts, cache_key=key, cache_dir=tmp_path)
    recorded = profiling.spans()
    assert [s.name for s in recorded] == ["embed_val"] and recorded[0].counts == {}
