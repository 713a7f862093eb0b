"""The share of the traced detections' time in which the card is idle and
the main thread waits for the ``Prefetcher`` (``prefetch.wait`` spans),
over the window less the data making, the base of ``device_idle_share``."""

from portbench.spans import idle_share


def read(rec):
    return idle_share(rec, ("prefetch.wait",))
