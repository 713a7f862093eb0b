"""The towers' least FLOPs over the device time of the kernels (no copy or
fill) that ran inside the program's ``embed_*`` phases, against the bf16
dense peak (989 TFLOP/s) whatever the precision. Images count the
``image_rows`` of the program's ``embed.images`` spans there, each at its
architecture module's ``image_flops``; texts count the detections' texts
at the lengths the module counts (as ``detect_mfu``), scaled to the
``text_rows`` of the ``embed.texts`` spans there (the tail batches' padding
rows included, as for images). None where those spans carry no row counts
(a program without them) or the run has no trace."""

from collections import Counter

from portbench import arch
from portbench.roofline import PEAK_FLOPS
from portbench.spans import embed_phases, intersect, length, program_spans, union
from portbench.traffic import SPLITS, Traffic


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def text_lengths(rec) -> Counter:
    """How many of the detections' texts have each length the module counts."""
    cfg, mix = rec.cell.config, rec.cell.mix
    model = arch.of(cfg)
    if mix["kind"] == "labels":
        labels = model.text_lengths([mix["prompt"] + name for name in Traffic.label_names(mix)], cfg)
        return Counter(labels[int(y)] for det in rec.detections for s in SPLITS for y in det.splits[s].y_noisy)
    return Counter(n for det in rec.detections for s in SPLITS for n in model.text_lengths(det.splits[s].texts, cfg))


def read(rec):
    spans = program_spans()
    if not rec.device_events or not spans or not rec.detections or rec.failed:
        return None
    region = embed_phases(rec, spans)
    inside = [s for s in spans if intersect([(s.start_ns, s.end_ns)], region)]
    image_rows = sum(s.counts.get("image_rows", 0) for s in inside if s.name == "embed.images")
    text_rows = sum(s.counts.get("text_rows", 0) for s in inside if s.name == "embed.texts")
    kernel_ns = length(intersect(union((a, b) for name, a, b in rec.device_events if _is_kernel(name)), region))
    if not (image_rows or text_rows) or not kernel_ns:
        return None
    cfg = rec.cell.config
    model = arch.of(cfg)
    lengths = text_lengths(rec)
    text = sum(model.text_flops(cfg, n) * c for n, c in lengths.items()) * text_rows / sum(lengths.values())
    flops = image_rows * model.image_flops(cfg) + text
    return 100.0 * flops / (kernel_ns / 1e9) / PEAK_FLOPS["bf16"]
