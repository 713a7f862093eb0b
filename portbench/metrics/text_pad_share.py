"""The share of the text tower's positions that lie after each row's first
EOT, where the tower pools: 100 x (1 - the ``eot_positions`` over the
``positions`` counted on the program's ``embed.texts`` spans inside the
``embed_*`` phases), in %. Under causal attention the pooled row reads none
of that work. None where those spans carry no such counts (a program
without them, or a text tower not pooled at the EOT)."""

from portbench.spans import embed_phases, intersect, program_spans


def read(rec):
    spans = program_spans()
    if not spans:
        return None
    region = embed_phases(rec, spans)
    eot = positions = 0
    for s in spans:
        if s.name == "embed.texts" and intersect([(s.start_ns, s.end_ns)], region):
            eot += s.counts.get("eot_positions", 0)
            positions += s.counts.get("positions", 0)
    return 100.0 * (1.0 - eot / positions) if positions else None
