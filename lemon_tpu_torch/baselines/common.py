"""Shared scaffolding of the detection baselines (port of
lemon_tpu/baselines/common.py): dataset and encoder set-up and the
reference's per-split evaluation and output files."""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.data.datasets import get_dataset
from lemon_tpu_torch.detect import DetectionConfig, _cache_kwargs as cache_kwargs, _labels_for, _texts_for_split
from lemon_tpu_torch.models.registry import create_encoder
from lemon_tpu_torch.scoring.metrics import eval_metrics

__all__ = ["BaselineConfig", "cache_kwargs", "evaluate_scores", "setup", "split_frame", "to_device"]


@dataclasses.dataclass
class BaselineConfig(DetectionConfig):
    method: str = ""  # baseline-specific
    temperature: float = 1.0  # CLIP-logits softmax temperature (README.md:65-70)
    # capfilt: local BLIP-ITM checkpoint dir (Salesforce/blip-itm-base-coco
    # role, run_capfilt_baseline.py:35-70). Distinct from ``checkpoint``,
    # which create_encoder consumes as CLIP weights.
    itm_checkpoint: Optional[str] = None


def setup(cfg: BaselineConfig, splits=None, encoder=None):
    """(splits, encoder, label_set, device) shared by the baselines. The
    device is ``cfg.platform``'s (``resolve_device``: the card by default,
    raising without one). A new encoder is built for each run, in the
    precision ``LEMON_TPU_PRECISION`` names, as the JAX package does;
    ``encoder`` injects any object with the ClipEncoder surface
    (``encode_texts`` / ``embed_split``)."""
    device = resolve_device(cfg.platform)
    if splits is None:
        splits = dict(
            zip(("train", "val", "test"), get_dataset(
                cfg.dataset, cfg.data_seed, noise_level=cfg.noise_level,
                noise_type=cfg.noise_type, synthetic_n=cfg.synthetic_n,
            ))
        )
    label_set = _labels_for(cfg)
    if encoder is None:
        encoder = create_encoder(cfg.clip_model, device, seed=cfg.seed, batch_size=cfg.batch_size,
                                 checkpoint=cfg.checkpoint)
    return splits, encoder, label_set, device


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def evaluate_scores(df, out_dir: Optional[Path], extra: Dict | None = None) -> Dict:
    """Shared evaluation and res.pkl output (discrepancy_baseline.py:249-272):
    thresholds chosen on val, reused on every split."""
    val = df[df.sset == "val"]
    prevalence = val["is_mislabel"].sum() / len(val)
    thress = eval_metrics(val["is_mislabel"], val["pred_score"], prevalence=prevalence)
    fix = {k: thress[k] for k in ("F1_optimal_thres", "F1_prev_thres", "F1_heuristic_thres")}
    agg = {}
    for sname in df.sset.unique():
        sub = df[df.sset == sname]
        agg[sname] = eval_metrics(sub["is_mislabel"], sub["pred_score"], prevalence=prevalence, fix_thress=fix)
    res = {"df": df, "agg_results": agg, **(extra or {})}
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "res.pkl", "wb") as f:
            pickle.dump(res, f)
        df.to_csv(out_dir / "scores.csv", index=False)
        (out_dir / "done").write_text("done")
    return res


def split_frame(cfg, splits, scores_by_split: Dict[str, np.ndarray]):
    """The per-example frame with ``pred_score``, split by split."""
    import pandas as pd

    rows = []
    for sname, scores in scores_by_split.items():
        split = splits[sname]
        _, _, noisy, actual = _texts_for_split(cfg, split, _labels_for(cfg))
        rows.append(
            pd.DataFrame(
                {
                    "sset": sname,
                    "idx": np.arange(len(split)),
                    "actual_label": np.asarray(actual),
                    "noisy_label": np.asarray(noisy),
                    "is_mislabel": split.is_mislabel,
                    "pred_score": np.asarray(scores),
                }
            )
        )
    return pd.concat(rows, ignore_index=True)
