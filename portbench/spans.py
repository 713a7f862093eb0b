"""The program's own spans (``lemon_tpu_torch.core.profiling.spans()``, on
``time.time_ns()``, the clock of the profiler's events) and the interval
arithmetic that the span metrics share. A program without the span
recorder gives no spans, and each metric that reads them then gives None.

Intervals are ``(start_ns, end_ns)``; a list of them is disjoint and in
order wherever it comes from :func:`union`, :func:`intersect` or
:func:`subtract`. Every time is taken in the window less the data making
(:func:`measured`), the base of ``device_idle_share``.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from portbench.harness import busy_intervals

Interval = Tuple[int, int]
DISPATCH = ("embed.images", "embed.texts")


def program_spans() -> list:
    from lemon_tpu_torch.core import profiling

    reader = getattr(profiling, "spans", None)
    return reader() if reader is not None else []


def union(intervals: Iterable[Interval]) -> List[Interval]:
    return busy_intervals(("", a, b) for a, b in intervals)


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    out = []
    for a, b in xs:
        for c, d in ys:
            if c >= b:
                break
            if d <= a:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def length(xs: Iterable[Interval]) -> int:
    return sum(b - a for a, b in xs)


def measured(rec) -> List[Interval]:
    """The window less the data making."""
    return subtract([rec.window_ns], union(rec.made_ns))


def embed_phases(rec, spans) -> List[Interval]:
    """The measured time inside the program's ``embed_*`` phases."""
    return intersect(measured(rec), union((s.start_ns, s.end_ns) for s in spans if s.name.startswith("embed_")))


def wall_ms_per_1k_pairs(rec, names: Tuple[str, ...]):
    """The wall time of the spans named ``names`` inside the ``embed_*``
    phases, in ms per 1000 pairs (the base of ``embed_ms_per_1k_pairs``)."""
    spans = program_spans()
    if not spans or not rec.pairs:
        return None
    region = embed_phases(rec, spans)
    wall = sum(length(intersect([(s.start_ns, s.end_ns)], region)) for s in spans if s.name in names)
    return wall / 1e6 / rec.pairs * 1e3


def idle_share(rec, names: Tuple[str, ...]):
    """The share of the measured time in which the card is idle (no kernel,
    copy or fill of the trace runs) and a span named in ``names`` is open:
    exact intersections of intervals, whatever the gaps' sizes."""
    spans = program_spans()
    if not rec.device_events or not spans:
        return None
    base = measured(rec)
    idle = subtract(base, union((a, b) for _, a, b in rec.device_events))
    open_ = union((s.start_ns, s.end_ns) for s in spans if s.name in names)
    return 100.0 * length(intersect(idle, open_)) / length(base)
