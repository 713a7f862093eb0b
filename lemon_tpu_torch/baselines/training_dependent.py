"""Training-dynamics baselines: AUM and Datamaps (port of
lemon_tpu/baselines/training_dependent.py; reference
lib/baselines/training_dependent_baselines.py:150-254 and
lib/metrics/distance_metrics.py:93-172).

A supervised classifier trains on the *noisy* labels (``y_noisy % n_classes``)
of every split, the val and test splits included and in ``train -> val ->
test`` order every epoch (these baselines score exactly the examples they
train on), with ``optax.sgd(lr, momentum)`` re-stated. Each step's own
train-mode softmax, taken before its update, is that epoch's probability of
its rows. Then

- AUM score = mean over epochs of margin(assigned label)  [low -> mislabel],
  reported as ``-aum``;
- Datamap = (mean confidence, variability) of P(assigned label), reported
  as ``-mean confidence``.

Per-epoch ``{val,test}_epoch_{e}.pkl`` files hold ``prediction``,
``true_class`` and ``label_flips``, as the JAX package writes them;
``runtime.npy`` the training's span.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from lemon_tpu_torch.baselines.common import BaselineConfig, evaluate_scores, split_frame
from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.data.datasets import get_dataset, iter_batches, load_images
from lemon_tpu_torch.detect import _labels_for
from lemon_tpu_torch.models.classifier import init_classifier
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.ops.image import preprocess_device
from lemon_tpu_torch.scoring.distance_metrics import aum_score, datamap_score
from lemon_tpu_torch.train.contrastive import Optimizer
from lemon_tpu_torch.train.downstream import make_classifier_step


def run_training_dependent(
    cfg: BaselineConfig,
    out_dir: Optional[Path] = None,
    splits=None,
    epochs: int = 10,
    lr: float = 1e-3,
    momentum: float = 0.9,
    model_cfg=None,
) -> Dict:
    """Train and score ``cfg.method`` ('aum' | 'datamap') on ``cfg.platform``'s
    device (the card by default, raising without one); ``model_cfg`` picks
    the backbone (default: the tiny CLIP tower)."""
    if cfg.method not in ("aum", "datamap"):
        raise ValueError(f"method must be 'aum' or 'datamap', got {cfg.method!r}")
    device = resolve_device(cfg.platform)
    if splits is None:
        splits = dict(zip(("train", "val", "test"), get_dataset(
            cfg.dataset, cfg.data_seed, noise_level=cfg.noise_level,
            noise_type=cfg.noise_type, synthetic_n=cfg.synthetic_n,
        )))
    n_classes = len(_labels_for(cfg))
    model_cfg = model_cfg or ClipConfig.tiny()
    size = model_cfg.image_resolution

    model = init_classifier(model_cfg, n_classes, cfg.seed).to(device)
    tx = Optimizer("sgd", lambda count: lr, momentum=momentum)
    step = make_classifier_step(model, tx, tx.init(list(model.parameters())))

    probs_by_phase = {s: [] for s in ("train", "val", "test")}
    t0 = time.time()
    for epoch in range(epochs):
        for phase in ("train", "val", "test"):
            split = splits[phase]
            epoch_probs = np.zeros((len(split), n_classes), np.float32)
            for idx, n_valid in iter_batches(split, cfg.batch_size):
                pixels = preprocess_device(load_images(split, idx, decode_size=size), size=size, device=device)
                labels = torch.from_numpy(split.y_noisy[idx] % n_classes).to(device)
                mask = torch.arange(len(idx), device=device) < n_valid
                loss, logits = step(pixels, labels, mask)
                if not np.isfinite(float(loss)):
                    raise FloatingPointError(f"epoch {epoch}, {phase}: non-finite loss {float(loss)}")
                epoch_probs[idx[:n_valid]] = torch.softmax(logits, -1)[:n_valid].cpu().numpy()
            probs_by_phase[phase].append(epoch_probs)
            if out_dir is not None and phase != "train":
                out_dir = Path(out_dir)
                out_dir.mkdir(parents=True, exist_ok=True)
                with open(out_dir / f"{phase}_epoch_{epoch}.pkl", "wb") as f:
                    pickle.dump({"prediction": epoch_probs, "true_class": split.y_noisy,
                                 "label_flips": split.is_mislabel}, f)
    runtime = time.time() - t0

    scores = {}
    for phase in ("train", "val", "test"):
        stack = np.stack(probs_by_phase[phase])  # (E, N, C)
        y = splits[phase].y_noisy % n_classes
        if cfg.method == "aum":
            scores[phase] = -aum_score(stack, y)  # low margin -> high mislabel score
        else:
            _, tuples = datamap_score(stack, y)
            scores[phase] = -tuples[:, 0]  # low mean confidence -> mislabel

    df = split_frame(cfg, splits, scores)
    if out_dir is not None:
        np.save(Path(out_dir) / "runtime.npy", np.array([runtime]))
    return evaluate_scores(df, out_dir)
