"""Zero-shot CLIP-logits baseline (port of lemon_tpu/baselines/zero_shot.py).

Reference: lib/baselines/train_zero_shot_clip_baseline.py:190-224. For a
classification dataset every class prompt is embedded once; per image the
score is the softmax over classes of (1 - distance to each class prompt) / T,
taken at the *noisy* label: mislabelled examples get low confidence. T is
the temperature the README discusses (README.md:65-70). The (N, C)
distances and the softmax run on the device; the Euclidean form's (rows, C,
D) differences in row chunks of at most ``DIFF_BUDGET`` bytes.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from lemon_tpu_torch.baselines.common import BaselineConfig, cache_kwargs, evaluate_scores, setup, split_frame, to_device
from lemon_tpu_torch.detect import _is_clf, prompt_fn

DIFF_BUDGET = 256 << 20


def class_distances(img: torch.Tensor, label_embs: torch.Tensor, dist_type: str) -> torch.Tensor:
    """(N, C) distances of the image rows to the class prompts."""
    if dist_type == "cosine":
        return 1.0 - img @ label_embs.T
    if dist_type == "euclidean":
        step = max(1, DIFF_BUDGET // (label_embs.numel() * 4))
        return torch.cat([((img[i : i + step, None, :] - label_embs[None]) ** 2).sum(-1) ** 0.5
                          for i in range(0, len(img), step)])
    raise NotImplementedError(dist_type)


def run_zero_shot_logits(cfg: BaselineConfig, out_dir: Optional[Path] = None, splits=None, encoder=None) -> Dict:
    assert _is_clf(cfg), "CLIP-logits baseline requires a classification dataset"
    splits, encoder, label_set, device = setup(cfg, splits, encoder)
    p = prompt_fn(cfg)
    label_embs = to_device(encoder.encode_texts([p(l) for l in label_set]), device)

    t0 = time.time()
    scores = {}
    for sname in ("train", "val", "test"):
        split = splits[sname]
        texts = [p(label_set[int(i) % len(label_set)]) for i in split.y_noisy]
        img, _ = encoder.embed_split(split, texts, **cache_kwargs(cfg, encoder, split, texts))
        img = to_device(img, device)
        d = class_distances(img, label_embs, cfg.dist_type)
        conf = torch.softmax((1.0 - d) / cfg.temperature, dim=1)
        noisy = torch.from_numpy(np.asarray(split.y_noisy, np.int64) % len(label_set)).to(device)
        scores[sname] = conf.gather(1, noisy[:, None])[:, 0].cpu().numpy()
    runtime = time.time() - t0

    df = split_frame(cfg, splits, scores)
    # confidence in the noisy label is LOW for mislabels: negated for the
    # shared evaluator, which reads high scores as "more mislabelled"
    df["pred_score"] = -df["pred_score"]
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / "dists.npy", np.concatenate([scores[s] for s in ("train", "val", "test")]))
        np.save(out_dir / "runtime.npy", np.array([runtime]))
    return evaluate_scores(df, out_dir)
