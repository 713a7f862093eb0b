"""The share of the traced detections' time in which nothing ran on the
card: one minus the union of the profiler's kernel, copy and fill
intervals, over the window less the data making."""

from portbench.harness import busy_seconds


def read(rec):
    if not rec.device_events:
        return None
    w0, w1 = rec.window_ns
    window_ns = w1 - w0 - sum(b - a for a, b in rec.made_ns)
    return 100.0 * (1.0 - busy_seconds(rec.device_events, rec.window_ns) * 1e9 / window_ns)
