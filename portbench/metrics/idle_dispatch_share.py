"""The share of the traced detections' time in which the card is idle and
the main thread is in a tower's call (``embed.images``, ``embed.texts``
spans), over the window less the data making."""

from portbench.spans import DISPATCH, idle_share


def read(rec):
    return idle_share(rec, DISPATCH)
