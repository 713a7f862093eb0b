"""Result aggregation: sweep output -> paper-style tables (port of
lemon_tpu/cli/aggregate.py; host-only numpy and pandas, the re-scoring on
the port's ``scoring`` and ``train.filtering``).

CLI port of notebooks/agg_results.ipynb and hparam_drop.ipynb:

- crawl ``**/done`` under a sweep root, join args.json with the flattened
  agg_results from each res.pkl;
- per (dataset, noise_type, noise_level, ablation) pick the (knn_k,
  dist_type) with the best mean validation F1 over data seeds
  (SELECTION_METRIC = know_val_labels_val_F1_optimal);
- report test AUROC/AUPRC/F1 mean±std for the winners (paper Tables 2-3);
- ``--hparam_drop``: re-score every run's stored components with the fixed
  no-validation hyperparameters {beta 5, gamma 5, tau_1 0.1, tau_2 5} and
  the prevalence-constrained threshold, measuring the no-val-labels gap.

Usage:
    python -m lemon_tpu_torch.cli.aggregate --root out/sweeps/lemon_all \
        [--hparam_drop] [--csv out/table.csv]
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path
from typing import Dict, List


def _flatten(prefix: str, obj) -> Dict:
    out = {}
    if isinstance(obj, dict):
        for key, val in obj.items():
            out.update(_flatten(f"{prefix}{key}_" if prefix else f"{key}_", val))
    else:
        out[prefix[:-1]] = obj
    return out


def collect_runs(root: Path) -> "object":
    """One row per completed run: args + flattened agg_results."""
    import pandas as pd

    rows: List[Dict] = []
    for marker in sorted(Path(root).glob("**/done")):
        run_dir = marker.parent
        try:
            args = json.loads((run_dir / "args.json").read_text())
            with open(run_dir / "res.pkl", "rb") as f:
                res = pickle.load(f)
        except FileNotFoundError:
            continue
        row = {**args, **_flatten("", res.get("agg_results", {}))}
        row["output_dir_small"] = run_dir.name
        rows.append(row)
    return pd.DataFrame(rows)


def paper_table(df, selection_metric: str = "know_val_labels_val_F1_optimal"):
    """Best (knn_k, dist_type) per config by mean val-F1 over seeds, then
    test metrics mean±std (agg_results.ipynb selection cells)."""
    import pandas as pd

    method = "know_val_labels"
    config_cols = [c for c in ("dataset", "noise_type", "noise_level", "ablation") if c in df]
    hparam_cols = [c for c in ("knn_k", "dist_type") if c in df]

    avg = (
        df.groupby(config_cols + hparam_cols, dropna=False)
        .agg(performance=(selection_metric, "mean"))
        .reset_index()
    )
    best = (
        avg.groupby(config_cols, dropna=False)
        .agg(performance=("performance", "max"))
        # reset_index so the merge joins on config_cols + performance —
        # joining on 'performance' alone loses config identity and, on
        # cross-config performance ties, selects another config's
        # (knn_k, dist_type) as this config's winner
        .reset_index()
        .merge(avg, on=config_cols + ["performance"])
        .drop_duplicates(subset=config_cols)
    )
    winners = best.drop(columns=["performance"]).merge(df)

    metrics = ["AUROC", "AUPRC", "F1_optimal"]
    rename = {f"{method}_test_{m}": m for m in metrics}
    cols = config_cols + hparam_cols + list(rename.keys())
    table = winners[[c for c in cols if c in winners]].rename(columns=rename)
    return (
        table.groupby(config_cols, dropna=False)
        .agg({**{m: ["mean", "std"] for m in metrics if m in table}, **({"knn_k": ["mean"]} if "knn_k" in table else {})})
        .sort_index()
    )


def hparam_drop_table(root: Path):
    """Re-score with fixed hyperparameters + prevalence threshold
    (hparam_drop.ipynb): how much is lost without validation labels."""
    import numpy as np
    import pandas as pd

    from lemon_tpu_torch.scoring.lemon import NeighborLogs, calc_scores
    from lemon_tpu_torch.scoring.metrics import eval_metrics
    from lemon_tpu_torch.train.filtering import FIXED_FILTER_HPARAMS

    rows = []
    for marker in sorted(Path(root).glob("**/done")):
        run_dir = marker.parent
        try:
            args = json.loads((run_dir / "args.json").read_text())
            with open(run_dir / "res.pkl", "rb") as f:
                df_run = pickle.load(f)["df"]
        except FileNotFoundError:
            continue
        if "baseline" in args or "judge" in args:
            # baseline/judge runs share the res.pkl {'df'} + done contract
            # but carry score frames without neighbor components — skip by
            # their args.json marker (a KeyError-based skip would also
            # swallow genuinely corrupt run_lemon frames)
            continue
        logs = NeighborLogs.from_dataframe(df_run)
        scores = calc_scores(logs, FIXED_FILTER_HPARAMS)
        val_mask = logs.sset == "val"
        prevalence = logs.is_mislabel[val_mask].mean()
        # threshold from the val prevalence constraint only (no labels)
        from lemon_tpu_torch.scoring.thresholds import f1_with_pred_prev_constraint

        _, thres = f1_with_pred_prev_constraint(
            logs.is_mislabel[val_mask], scores[val_mask], prevalence, return_thres=True
        )
        test_mask = logs.sset == "test"
        m = eval_metrics(
            logs.is_mislabel[test_mask], scores[test_mask], prevalence=prevalence,
            fix_thress={"F1_optimal_thres": thres, "F1_prev_thres": thres, "F1_heuristic_thres": thres},
        )
        rows.append({**{k: args.get(k) for k in ("dataset", "noise_type", "noise_level", "knn_k", "dist_type", "data_seed")},
                     "AUROC": m["AUROC"], "AUPRC": m["AUPRC"], "F1_prev": m["F1_prev"]})
    return pd.DataFrame(rows)


def main(argv=None):
    parser = argparse.ArgumentParser(description="lemon_tpu_torch result aggregation")
    parser.add_argument("--root", required=True)
    parser.add_argument("--selection_metric", default="know_val_labels_val_F1_optimal")
    parser.add_argument("--hparam_drop", action="store_true")
    parser.add_argument("--csv", default=None)
    args = parser.parse_args(argv)

    if args.hparam_drop:
        table = hparam_drop_table(Path(args.root))
    else:
        df = collect_runs(Path(args.root))
        if df.empty:
            print("no completed runs found")
            return
        print(f"collected {len(df)} completed runs")
        table = paper_table(df, args.selection_metric)
    print(table.to_string())
    if args.csv:
        table.to_csv(args.csv)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
