"""Pairs of all detections over the window, from its start to the end of
the last detection (host clock; the window ends in a device sync), less
the time the benchmark spent making the datasets."""


def read(rec):
    if not rec.detections or rec.failed:
        return None
    return rec.pairs / rec.window_s
