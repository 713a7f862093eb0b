"""The least model FLOPs of every detection in the window over the window,
against the bf16 dense peak (989 TFLOP/s) whatever the precision: every
image, every text at its length up to its EOT (the reference tokenizer's),
and each search's product (portbench.roofline.detection_flops)."""

from portbench.reference.tokenizer import Tokenizer
from portbench.roofline import PEAK_FLOPS, detection_flops
from portbench.traffic import SPLITS, Traffic


def read(rec):
    if not rec.detections or rec.failed:
        return None
    cfg, mix = rec.cell.config, rec.cell.mix
    tok, ctx = Tokenizer(), cfg["context_length"]
    prompt, labels = mix.get("prompt"), None
    if mix["kind"] == "labels":
        labels = [min(len(tok.encode(prompt + name)) + 2, ctx) for name in Traffic.label_names(mix)]
    flops = 0.0
    for det in rec.detections:
        lengths = []
        for s in SPLITS:
            split = det.splits[s]
            if labels is not None:
                lengths += [labels[int(y)] for y in split.y_noisy]
            else:
                lengths += [min(len(tok.encode(t)) + 2, ctx) for t in split.texts]
        n_db = len(det.splits["train"])
        searches = [(len(det.splits[s]), n_db) for s in SPLITS for _ in range(2)]
        flops += detection_flops(cfg, det.pairs, lengths, searches)
    return 100.0 * flops / rec.window_s / PEAK_FLOPS["bf16"]
