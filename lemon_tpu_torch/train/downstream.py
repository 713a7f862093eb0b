"""Downstream filter-then-train classification (port of
lemon_tpu/train/downstream.py; reference
lib/downstream/train_downstream_classification.py):

1. load a detector run's per-example scores (``dists.npy`` or a LEMoN
   ``{criteria}_scores.csv``), drop training examples above a percentile
   (:142-148 — a higher score is more likely mislabelled),
2. fine-tune an image classifier on the kept noisy-labelled data with
   AdamW on a cosine schedule and best-val-accuracy early stopping
   (:150-202),
3. report average and worst-group accuracy (:204-233,
   lib/metrics/utils.py:235-254).

The optimizer is ``optax.adamw(cosine_decay_schedule(lr, epochs ·
steps_per_epoch), weight_decay)`` re-stated (``train/contrastive.Optimizer``:
decay on every parameter, eps outside the square root, the schedule read at
the update count from 0). Batches have one shape: the last one of an epoch
wraps around and masks its padded rows out of the loss. The best weights are
``ckpt.pt``, a ``torch.save`` of the state dict with its buffers, where JAX
writes ``ckpt.msgpack`` (ROADMAP: handled divergences); the CIFAR-10-C
evaluation reads the port's files. No kernel of the port runs here: the
backbones take plain attention and PyTorch's convolutions, as the JAX
package computes them in XLA.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.core.io import EarlyStopping, json_default
from lemon_tpu_torch.data.datasets import ClassificationSplit, iter_batches, load_images
from lemon_tpu_torch.models.classifier import ImageClassifier, classification_loss, init_classifier
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.ops.image import preprocess_device
from lemon_tpu_torch.train.contrastive import Optimizer, cosine_decay_schedule


@dataclasses.dataclass
class DownstreamConfig:
    num_classes: int = 10
    percentile: float = 60.0  # keep scores below this percentile
    epochs: int = 20
    batch_size: int = 128
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    freeze_backbone: bool = False
    es_patience: int = 5
    seed: int = 0
    # ClipConfig | TvResNetSpec | GoogleViTConfig — selects the backbone
    # as get_img_base's name does (lib/models/utils.py:49-61)
    model_cfg: object = dataclasses.field(default_factory=ClipConfig.tiny)


def filter_split(split: ClassificationSplit, scores: np.ndarray, percentile: float) -> ClassificationSplit:
    """Drop rows whose mislabel score exceeds the percentile threshold
    (train_downstream_classification.py:142-148)."""
    if len(scores) != len(split):
        raise ValueError(f"{len(scores)} scores for a split of {len(split)} rows")
    thres = np.percentile(scores, percentile)
    keep = np.flatnonzero(scores <= thres)
    if not len(keep):
        raise ValueError("the filter kept nothing")
    return split.subset(keep)


def load_detector_scores(path: Path, split_name: str = "train") -> np.ndarray:
    """Scores from either a baseline's dists.npy (with its datasplit.npy) or
    a LEMoN scores CSV (the reference's cross-run contract)."""
    path = Path(path)
    if path.suffix == ".npy":
        dists = np.load(path)
        split_tags = np.load(path.parent / "datasplit.npy", allow_pickle=True)
        return dists[np.asarray(split_tags).ravel() == split_name]
    import pandas as pd

    # run_lemon CSVs carry an unnamed index column; pandas parses it as
    # 'Unnamed: 0' and the named columns come through either way
    df = pd.read_csv(path)
    if "sset" not in df.columns or "pred_score" not in df.columns:
        raise ValueError(f"{path} is not a detector scores CSV (needs sset/pred_score columns)")
    return df.loc[df.sset == split_name, "pred_score"].to_numpy()


def make_classifier_step(model: ImageClassifier, tx: Optimizer, opt_state: Dict):
    """``step(pixels, labels, mask) -> (loss, logits)``: the train-mode
    forward (BatchNorm on batch statistics, updating its running ones), the
    masked loss and one update of every parameter in place. A parameter
    with no gradient (the backbone under ``freeze_backbone``) takes a zero
    one, so AdamW still decays it, as optax does."""
    params = list(model.parameters())

    def step(pixels: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
        for p in params:
            p.grad = None
        logits = model.train()(pixels)
        loss = classification_loss(logits, labels, mask)
        loss.backward()
        tx.update(params, [p.grad if p.grad is not None else torch.zeros_like(p) for p in params], opt_state)
        return loss.detach(), logits.detach()

    return step


@torch.no_grad()
def _predict_split(model, split, batch_size, image_size, device):
    """(probs, pred_y) over a split in eval mode (BatchNorm on its running
    statistics), in padded batches of one shape."""
    model.eval()
    preds = []
    for idx, n_valid in iter_batches(split, batch_size):
        pixels = preprocess_device(load_images(split, idx, decode_size=image_size), size=image_size, device=device)
        preds.append(torch.softmax(model(pixels), dim=-1)[:n_valid].cpu().numpy())
    probs = np.concatenate(preds)
    return probs, probs.argmax(axis=1)


def _epoch_batches(split, batch_size, image_size, rng, device):
    """One epoch in the order ``rng`` draws: the last batch pads by wrapping
    (also when the split is smaller than a batch) and reports ``n_valid``,
    so the padded rows can be masked out of the loss — each sample then
    counts once an epoch, like the reference's DataLoader with its ragged
    final batch."""
    order = rng.permutation(len(split))
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        n_valid = len(idx)
        if n_valid < batch_size:
            idx = np.concatenate([idx, np.resize(order, batch_size - n_valid)])
        pixels = preprocess_device(load_images(split, idx, decode_size=image_size), size=image_size, device=device)
        yield pixels, torch.from_numpy(split.y_noisy[idx]).to(device), n_valid


def train_downstream(
    cfg: DownstreamConfig,
    splits: Dict[str, ClassificationSplit],
    detector_scores: Optional[np.ndarray] = None,
    out_dir: Optional[Path] = None,
    device: Optional[torch.device] = None,
) -> Dict:
    """Filter, fine-tune, evaluate the best weights on val and test. Runs on
    ``device`` (default: the CUDA card, raising without one). Writes
    ``{val,test}_pred_y.npy``, ``{val,test}_probs.npy``, ``results.json``,
    ``ckpt.pt`` and ``done`` under ``out_dir``."""
    device = resolve_device("cuda") if device is None else device
    train = splits["train"]
    if detector_scores is not None:
        kept = filter_split(train, detector_scores, cfg.percentile)
        print(f"filter: kept {len(kept)}/{len(train)} train examples")
        train = kept

    model = init_classifier(cfg.model_cfg, cfg.num_classes, cfg.seed, cfg.freeze_backbone).to(device)
    steps_per_epoch = max(len(train) // cfg.batch_size, 1)
    tx = Optimizer("adamw", cosine_decay_schedule(cfg.learning_rate, cfg.epochs * steps_per_epoch),
                   weight_decay=cfg.weight_decay)
    step = make_classifier_step(model, tx, tx.init(list(model.parameters())))
    size = cfg.model_cfg.image_resolution

    def eval_split(split):
        probs, pred_y = _predict_split(model, split, cfg.batch_size, size, device)
        return probs, pred_y, (pred_y == split.y_clean).mean()

    rng = np.random.default_rng(cfg.seed)
    es = EarlyStopping(patience=cfg.es_patience, mode="max")
    es.seed(-1.0, model)  # any real val_acc beats the placeholder
    t0 = time.time()
    for epoch in range(cfg.epochs):
        losses = []
        for pixels, labels, n_valid in _epoch_batches(train, cfg.batch_size, size, rng, device):
            mask = torch.arange(len(labels), device=device) < n_valid
            loss, _ = step(pixels, labels, mask)
            losses.append(float(loss))
            if not np.isfinite(losses[-1]):
                raise FloatingPointError(f"epoch {epoch}: non-finite loss {losses[-1]}")
        _, _, val_acc = eval_split(splits["val"])
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} val_acc {val_acc:.4f}")
        es.step(val_acc, model)
        if es.should_stop:
            print(f"early stop at epoch {epoch} (best val_acc {es.best:.4f})")
            break
    model.load_state_dict(es.best_payload)
    runtime = time.time() - t0

    results = {"val_acc_best": es.best, "runtime_s": runtime}
    for sname in ("val", "test"):
        split = splits[sname]
        probs, pred_y, acc = eval_split(split)
        g = _group_accuracy(pred_y, split.y_clean)
        results[sname] = {
            "accuracy": float(acc),
            "worst_group_accuracy": g["worst_accuracy"],
            "groups": g["group_metrics"],
        }
        if out_dir is not None:
            out_dir = Path(out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            np.save(out_dir / f"{sname}_pred_y.npy", pred_y)
            np.save(out_dir / f"{sname}_probs.npy", probs)
    if out_dir is not None:
        (Path(out_dir) / "results.json").write_text(json.dumps(results, default=json_default))
        # the best weights (the reference's ckpt.pth, train_downstream_classification.py:181),
        # which the CIFAR-10-C evaluation below reads
        torch.save({k: v.cpu() for k, v in es.best_payload.items()}, Path(out_dir) / "ckpt.pt")
        (Path(out_dir) / "done").write_text("done")
    return results


def _group_accuracy(pred_y: np.ndarray, true_y: np.ndarray) -> Dict:
    """Average / worst-group accuracy over true-class groups
    (lib/metrics/utils.py:235-254 via compute_robustness_cifar10c)."""
    group_stats = {}
    for cls in np.unique(true_y):
        mask = true_y == cls
        group_stats[int(cls)] = {"accuracy": float((pred_y[mask] == cls).mean()), "n": int(mask.sum())}
    return {
        "average_accuracy": float((pred_y == true_y).mean()),
        "worst_accuracy": min(g["accuracy"] for g in group_stats.values()),
        "group_metrics": group_stats,
    }


def evaluate_cifar10c(
    cfg: DownstreamConfig,
    checkpoints,
    corruption_name: str,
    out_dir: Path,
    test_split: Optional[ClassificationSplit] = None,
    device: Optional[torch.device] = None,
) -> Dict:
    """Inference-mode robustness evaluation (the reference's
    ``--dataset cifar10c --num_epochs 0`` branch,
    train_downstream_classification.py:112-114,193-198,355-358): each
    trained checkpoint (a ``ckpt.pt`` of :func:`train_downstream`) is
    evaluated on the corrupted test set; per model the prediction npys and
    a ``results_{corruption}_{model_count}.pkl`` with average / worst-group
    accuracy are written."""
    device = resolve_device("cuda") if device is None else device
    if test_split is None:
        from lemon_tpu_torch.data.datasets import load_cifar10c

        test_split = load_cifar10c(corruption_name)
    model = init_classifier(cfg.model_cfg, cfg.num_classes, cfg.seed, cfg.freeze_backbone).to(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    all_results = {}
    for model_count, ckpt in enumerate(checkpoints):
        model.load_state_dict(torch.load(ckpt, map_location=device, weights_only=True))
        _, pred_y = _predict_split(model, test_split, cfg.batch_size, cfg.model_cfg.image_resolution, device)
        np.save(out_dir / f"test_pred_y_{corruption_name}_{model_count}.npy", pred_y)
        np.save(out_dir / f"test_true_y_{corruption_name}_{model_count}.npy", test_split.y_clean)
        results = _group_accuracy(pred_y, test_split.y_clean)
        with open(out_dir / f"results_{corruption_name}_{model_count}.pkl", "wb") as f:
            pickle.dump(results, f)
        all_results[model_count] = results
    (out_dir / "done").write_text("done")
    return all_results
