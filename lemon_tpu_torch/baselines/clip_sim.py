"""CLIP-similarity baseline, d_1 only (port of lemon_tpu/baselines/clip_sim.py).

Reference: lib/baselines/run_clip_sim.py:174-256. Per pair, the score is
the modality distance between the image embedding and the (noisy) text
embedding; saved as dists.npy / label_flips.npy / datasplit.npy /
runtime.npy, and evaluated inline (AUROC/F1) as in the JAX package.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from lemon_tpu_torch.baselines.common import BaselineConfig, cache_kwargs, evaluate_scores, setup, split_frame
from lemon_tpu_torch.detect import _is_clf, _texts_for_split
from lemon_tpu_torch.scoring.distance_metrics import pair_distances


def run_clip_sim(cfg: BaselineConfig, out_dir: Optional[Path] = None, splits=None, encoder=None) -> Dict:
    splits, encoder, label_set, _ = setup(cfg, splits, encoder)
    t0 = time.time()
    scores, flips, split_tags = {}, [], []
    for sname in ("train", "val", "test"):
        split = splits[sname]
        if _is_clf(cfg):
            # run_clip_sim.py:198-216 embeds the BARE class word: no
            # 'A photo of a' prompt (unlike run_lemon and zero-shot)
            noisy_texts = [label_set[int(i) % len(label_set)] for i in split.y_noisy]
        else:
            noisy_texts, _, _, _ = _texts_for_split(cfg, split, label_set)
        # content-keyed cache shared with run_lemon sweeps (same data and
        # weights => same entries, whichever pipeline embedded first)
        img, txt = encoder.embed_split(split, noisy_texts, **cache_kwargs(cfg, encoder, split, noisy_texts))
        # O(N*D) float64 on the host, as in the JAX package
        scores[sname] = pair_distances(txt, img, cfg.dist_type)
        flips.append(split.is_mislabel)
        split_tags.append(np.full(len(split), sname, object))
    runtime = time.time() - t0

    df = split_frame(cfg, splits, scores)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / "dists.npy", np.concatenate([scores[s] for s in ("train", "val", "test")]))
        np.save(out_dir / "label_flips.npy", np.concatenate(flips))
        np.save(out_dir / "datasplit.npy", np.concatenate(split_tags))
        np.save(out_dir / "runtime.npy", np.array([runtime]))
    return evaluate_scores(df, out_dir)
