"""The host's time in the towers' calls (the program's ``embed.images`` and
``embed.texts`` spans: preprocessing, uploads and the towers' launches)
inside the ``embed_*`` phases, in ms per 1000 pairs."""

from portbench.spans import DISPATCH, wall_ms_per_1k_pairs


def read(rec):
    return wall_ms_per_1k_pairs(rec, DISPATCH)
