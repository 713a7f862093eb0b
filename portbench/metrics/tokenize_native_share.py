"""The share of the texts' rows that the program's C++ BPE encoded: the
``native_rows`` counts over ``native_rows + python_rows``, summed over the
program's ``embed.tokenize`` spans inside the ``embed_*`` phases, in %. None
where those spans carry no such counts (a program without them)."""

from portbench.spans import embed_phases, intersect, program_spans


def read(rec):
    spans = program_spans()
    if not spans:
        return None
    region = embed_phases(rec, spans)
    native = rows = 0
    for s in spans:
        if s.name == "embed.tokenize" and intersect([(s.start_ns, s.end_ns)], region):
            native += s.counts.get("native_rows", 0)
            rows += s.counts.get("native_rows", 0) + s.counts.get("python_rows", 0)
    return 100.0 * native / rows if rows else None
