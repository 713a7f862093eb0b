"""The least model FLOPs of every detection in the window over the window,
against the bf16 dense peak (989 TFLOP/s) whatever the precision: every
image, every text at the length its architecture module counts
(``text_lengths``; OpenAI CLIP: up to and with its EOT, by the reference
tokenizer), and each search's product (portbench.roofline.detection_flops)."""

from portbench import arch
from portbench.roofline import PEAK_FLOPS, detection_flops
from portbench.traffic import SPLITS, Traffic


def read(rec):
    if not rec.detections or rec.failed:
        return None
    cfg, mix = rec.cell.config, rec.cell.mix
    model = arch.of(cfg)
    labels = None
    if mix["kind"] == "labels":
        labels = model.text_lengths([mix["prompt"] + name for name in Traffic.label_names(mix)], cfg)
    flops = 0.0
    for det in rec.detections:
        lengths = []
        for s in SPLITS:
            split = det.splits[s]
            if labels is not None:
                lengths += [labels[int(y)] for y in split.y_noisy]
            else:
                lengths += model.text_lengths(split.texts, cfg)
        n_db = len(det.splits["train"])
        searches = [(len(det.splits[s]), n_db) for s in SPLITS for _ in range(2)]
        flops += detection_flops(cfg, det.pairs, lengths, searches)
    return 100.0 * flops / rec.window_s / PEAK_FLOPS["bf16"]
