"""The consumer's waits for the ``Prefetcher``'s batches (the program's
``prefetch.wait`` spans) inside the ``embed_*`` phases, in ms per 1000
pairs, the base of ``embed_ms_per_1k_pairs``."""

from portbench.spans import wall_ms_per_1k_pairs


def read(rec):
    return wall_ms_per_1k_pairs(rec, ("prefetch.wait",))
