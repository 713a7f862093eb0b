"""Readings that the limits of ``correct`` are set from.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 ... [--who program fit-first-point ...]

For each seed, in one process: set-up as a run makes it, one detection
(index 0) through the timed path, then the check's numbers for these
stand-ins of the program's outputs (``--who`` keeps some of them):

- ``program``: the program itself (a lower reading);
- ``control``: the reference in the program's place, each stage at the
  precision below the program's (:func:`portbench.check.control_outputs`;
  TF32 towers for fp32 configurations, int8 for bf16 ones);
- ``program-int8``, for a bf16 configuration: the program's own int8 path
  (``Precision.int8``: W8A8 projections in the vision tower) on the same
  detection, the program's path one precision below bf16;
- ``fit-first-point`` and ``fit-grid-only``: the program with its fit cut
  short (:func:`fit_cut_short`), the faults that ``fit_gap`` is read
  against.

Each reading is a JSON line on standard output. The benchmark's own runs
do not run this.
"""

import argparse
import dataclasses
import json
import sys
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from portbench import check as chk
from portbench import harness
from portbench.traffic import Traffic
from portbench.weights import make_weights


STAND_INS = ("program", "control", "program-int8", "fit-first-point", "fit-grid-only")


def fit_cut_short(got: chk.Outputs, det, device: torch.device, how: str) -> chk.Outputs:
    """The program's outputs with its fit cut short, the rest of what
    follows from the fit (scores, AUROC) worked out as the program does at
    that choice: ``fit-first-point`` returns the grid's first point (every
    hyperparameter 0, the score d_1 alone); ``fit-grid-only`` keeps the
    grid's leaders and skips the L-BFGS restarts and the Powell polish."""
    from lemon_tpu_torch.scoring import optimize
    from lemon_tpu_torch.scoring.lemon import HPARAM_ORDER, NeighborLogs, calc_scores, unpack_hparams
    from lemon_tpu_torch.scoring.thresholds import optimize_f1_efficient

    mis = np.concatenate([det.splits[n].is_mislabel for n in chk.SPLITS])
    logs = NeighborLogs(**{c: np.asarray(got.logs[c]) for c in chk.COMPONENTS}, is_mislabel=mis,
                        sset=np.asarray(got.logs["sset"]))
    val = logs.select(logs.sset == "val")
    if how == "fit-first-point":
        hp = dict.fromkeys(HPARAM_ORDER, 0.0)
        f1, thres = optimize_f1_efficient(val.is_mislabel, calc_scores(val, hp), return_thres=True)
    else:
        no_polish = lambda fun, x0, **kw: SimpleNamespace(fun=np.inf, x=np.asarray(x0))  # noqa: E731
        with mock.patch.object(optimize, "minimize", no_polish):
            x, f1, thres = optimize.maximize_metric(val, x0s=(), device=device)
        hp = unpack_hparams(x)
    scores = np.asarray(calc_scores(logs, hp), np.float64)
    aurocs = {n: chk.auroc(det.splits[n].is_mislabel, scores[logs.sset == n]) for n in chk.SPLITS}
    return dataclasses.replace(got, hparams={h: float(hp[h]) for h in chk.HPARAMS},
                               fit={"thres": float(thres), "selected_val": float(f1)}, scores=scores, auroc=aurocs)


def readings(cell: harness.Cell, seed: int, device: torch.device, who=STAND_INS):
    """(who, numbers) for each stand-in, on detection 0 of ``seed``."""
    cfg, mix = cell.config, cell.mix
    n_rows = mix["check_rows"]
    W = make_weights(cfg, seed, device)
    traffic = Traffic(mix, seed, device)
    det = traffic.detection(0)
    out = {}
    runs = [("program", cfg)]
    if cfg["precision"] == "bf16" and "program-int8" in who:
        runs.append(("program-int8", dict(cfg, precision="int8")))
    for name, c in runs:
        encoder = harness.build_encoder(c, W, device, mix["detection"]["batch_size"], seed)
        harness.warm_up(encoder, traffic, mix, device, seed)
        got = harness.run_detection(encoder, det, mix, device, harness.RecordingTimer(device))
        del encoder
        out[name] = chk.check(got, det, traffic, W, cfg, device, seed, n_rows)
        if name != "program":
            continue
        if "control" in who:
            mode = "tf32" if cfg["precision"] == "fp32" else "int8"
            ctl = chk.control_outputs(got, det, traffic, W, cfg, device, seed, n_rows, mode)
            out["control"] = chk.check(ctl, det, traffic, W, cfg, device, seed, n_rows)
        for fault in ("fit-first-point", "fit-grid-only"):
            if fault in who:
                # the stages before the fit are the program's
                out[fault] = {**out["program"], **chk.check_fit(fit_cut_short(got, det, device, fault), det, device)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--who", nargs="+", choices=STAND_INS, default=STAND_INS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 3
    from lemon_tpu_torch.core.device import resolve_device

    device = resolve_device("cuda")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell.load(bench, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for who, numbers in readings(cell, seed, device, args.who).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "who": who, **numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
