"""The BPE of the texts (the program's ``embed.tokenize`` spans, on the
``Prefetcher``'s thread in ``embed_split``) inside the ``embed_*`` phases,
in ms per 1000 pairs."""

from portbench.spans import wall_ms_per_1k_pairs


def read(rec):
    return wall_ms_per_1k_pairs(rec, ("embed.tokenize",))
