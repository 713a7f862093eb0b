"""The rate of the embed layer's uploads: the ``h2d_bytes`` that the
program's spans counted inside the ``embed_*`` phases over the device time
of the trace's host-to-device copies there, in GB/s (bytes per ns)."""

from portbench.spans import embed_phases, intersect, length, program_spans


def read(rec):
    spans = program_spans()
    if not rec.device_events or not spans:
        return None
    region = embed_phases(rec, spans)
    nbytes = sum(s.counts.get("h2d_bytes", 0) for s in spans if any(a <= s.start_ns < b for a, b in region))
    copy_ns = sum(length(intersect([(a, b)], region)) for name, a, b in rec.device_events if "HtoD" in name)
    return nbytes / copy_ns if copy_ns else None
