"""Detection-driven data curation, the CC3M filtering mode (port of
lemon_tpu/train/filtering.py; reference train_clip_from_scratch.py:93-124).

From a prior LEMoN run's ``res.pkl`` (the port's or the JAX package's: the
same dataframe), the scores are computed again with the fixed
no-validation hyperparameters {beta 5, gamma 5, tau_1 0.1, tau_2 5} (or
``d_1`` under the ``multimodal_baseline`` ablation), and the ``keep_n``
lowest-scoring (cleanest) examples are kept for training.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from lemon_tpu_torch.scoring.lemon import NeighborLogs, calc_scores

FIXED_FILTER_HPARAMS = {
    "beta": 5.0,
    "gamma": 5.0,
    "tau_1_n": 0.1,
    "tau_2_n": 5.0,
    "tau_1_m": 0.1,
    "tau_2_m": 5.0,
}


def filter_indices_from_run(run_dir: Path, keep_n: int, split: str = "train") -> np.ndarray:
    """Indices (into the split) of the ``keep_n`` cleanest examples. The
    run directory is one this program or the JAX package wrote: ``res.pkl``
    is unpickled."""
    run_dir = Path(run_dir)
    with open(run_dir / "res.pkl", "rb") as f:
        df = pickle.load(f)["df"]
    df = df[df.sset == split]
    run_args = json.loads((run_dir / "args.json").read_text())
    if run_args.get("ablation") == "multimodal_baseline":
        scores = df["d_1"].to_numpy()
    else:
        scores = calc_scores(NeighborLogs.from_dataframe(df), FIXED_FILTER_HPARAMS)
    order = np.argsort(scores, kind="stable")  # ascending: cleanest first
    return df["idx"].to_numpy()[order[:keep_n]]
