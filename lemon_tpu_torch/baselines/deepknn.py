"""Deep-kNN label-agreement baseline, SimiFeat-style (port of
lemon_tpu/baselines/deepknn.py).

The reference script (lib/baselines/run_deepknn.py) imports a module that is
absent from its repository; the JAX package reconstructs it from the
primitive it drives, ``count_knn_distribution`` (lib/metrics/utils.py:205-233):

1. class labels: the dataset's labels for classification sets; k-means
   clusters of the train captions for captioning sets (run_deepknn.py:160-166
   via lib/datasets/clustering.py), at most ``min(100, n_train // 2)``;
2. features: the CLIP image embeddings of each split;
3. per example, a weighted kNN vote distribution over classes
   (:func:`knn_label_distribution`: K1 ``ip/highest`` and K2 on the card);
   the score is 1 - P_knn(assigned noisy label).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from lemon_tpu_torch.baselines.common import BaselineConfig, cache_kwargs, evaluate_scores, setup, split_frame
from lemon_tpu_torch.detect import _is_clf, _texts_for_split
from lemon_tpu_torch.scoring.distance_metrics import knn_label_distribution


def run_deepknn(cfg: BaselineConfig, out_dir: Optional[Path] = None, splits=None, encoder=None, n_clusters: int = 100) -> Dict:
    splits, encoder, label_set, device = setup(cfg, splits, encoder)
    k = max(cfg.knn_k, 3)  # the SimiFeat self-extrapolation needs >= 3

    t0 = time.time()
    if _is_clf(cfg):
        labels = {s: np.asarray(splits[s].y_noisy) for s in splits}
        n_classes = len(label_set)
    else:
        from lemon_tpu_torch.data.clustering import cluster_caption_text

        km, train_clusters = cluster_caption_text(
            list(splits["train"].sentence), n_clusters=min(n_clusters, len(splits["train"]) // 2),
            encoder=encoder, seed=cfg.seed,
        )
        labels = {
            "train": train_clusters,
            "val": km.predict(list(splits["val"].sentence)),
            "test": km.predict(list(splits["test"].sentence)),
        }
        n_classes = km.km.n_clusters

    scores = {}
    for sname in ("train", "val", "test"):
        split = splits[sname]
        noisy_texts, _, _, _ = _texts_for_split(cfg, split, label_set)
        img, _ = encoder.embed_split(split, noisy_texts, **cache_kwargs(cfg, encoder, split, noisy_texts))
        y = labels[sname] % n_classes
        probs = knn_label_distribution(img, y, n_classes, k=k, norm="l1", device=device)
        scores[sname] = 1.0 - probs[np.arange(len(split)), y]
    runtime = time.time() - t0

    df = split_frame(cfg, splits, scores)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / "runtime.npy", np.array([runtime]))
    return evaluate_scores(df, out_dir)
