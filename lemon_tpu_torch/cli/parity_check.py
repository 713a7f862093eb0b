"""Real-data AUROC parity harness (BASELINE.json acceptance config 1): port
of lemon_tpu/cli/parity_check.py, driving the port's ``run_lemon``.

Runs the reference's CPU-runnable acceptance configuration — CIFAR-10,
noise 0.4, ViT-B/32 — end-to-end and prints the test AUROC. Requires on
disk (no network in this environment):

- CIFAR-10 python pickles under $LEMON_TPU_DATA_ROOT (default ./data)
- an openai/clip-vit-base-patch32 checkpoint via
  LEMON_TPU_CKPT_HUGGINGFACE_CLIP (HF CLIPModel .bin/.safetensors or
  OpenAI-format .pt)
- optionally ./data/CIFAR-10_human.pt for --noise_type real

The acceptance bar is AUROC within 0.001 of the reference run with the
same seeds (SURVEY.md §6). Without the checkpoint this script refuses to
run (random weights would make the number meaningless).

    python -m lemon_tpu_torch.cli.parity_check --output_dir out/parity \
        [--noise_type symmetric] [--knn_k 5] [--reference_auroc 0.xxxx]

Auto mode probes well-known locations for the assets (see
``probe_assets`` and DATASOURCES.md for the exact file manifest) and runs
every configuration whose assets are present, with no flags needed:

    python -m lemon_tpu_torch.cli.parity_check --auto [--output_dir out/parity]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

# Candidate dataset roots, probed in order (first hit wins and is exported
# as LEMON_TPU_DATA_ROOT for the run). $LEMON_TPU_DATA_ROOT itself, when
# set, is always first. The JAX list also names the root user's home
# directly; "~/data" names it for that user.
_CANDIDATE_ROOTS = ("./data", "/data", "~/data", "~/datasets")

# Exact file manifest per asset (documented in DATASOURCES.md).
_ASSET_FILES = {
    "cifar10": [f"cifar-10-batches-py/data_batch_{i}" for i in range(1, 6)]
    + ["cifar-10-batches-py/test_batch"],
    "cifar100": ["cifar-100-python/train", "cifar-100-python/test"],
    "cifar10n": ["CIFAR-10_human.pt"],
    "cifar100n": ["CIFAR-100_human.pt"],
}
_ASSET_TARBALLS = {"cifar10": "cifar-10-python.tar.gz", "cifar100": "cifar-100-python.tar.gz"}


def _find_hf_clip_checkpoint(extra_roots=()):
    """openai/clip-vit-base-patch32 weights: env var, data-root checkpoints
    dirs (registry resolution order, models/registry.py:41-51 — the env
    root, ``extra_roots``, then every candidate root so --auto finds a
    checkpoint wherever the datasets were found), then any huggingface_hub
    cache on disk.

    An explicitly-set LEMON_TPU_CKPT_HUGGINGFACE_CLIP pointing at a
    missing file is a hard error, NOT a fallthrough — silently
    substituting a different checkpoint would report a parity AUROC
    against weights the user did not select."""
    env = os.environ.get("LEMON_TPU_CKPT_HUGGINGFACE_CLIP")
    if env:
        if Path(env).expanduser().exists():
            return Path(env).expanduser()
        sys.exit(
            f"LEMON_TPU_CKPT_HUGGINGFACE_CLIP={env!r} does not exist; refusing "
            "to fall back to another checkpoint (unset the variable to let "
            "parity_check probe the data roots and HF hub cache)."
        )
    roots = []
    if os.environ.get("LEMON_TPU_DATA_ROOT"):
        roots.append(os.environ["LEMON_TPU_DATA_ROOT"])
    roots += list(extra_roots) + list(_CANDIDATE_ROOTS)
    seen = set()
    for root in roots:
        root = Path(root).expanduser()
        # one directory under two names (a symlink, a relative path) is
        # probed once: the JAX file dedups on the path as given
        key = root.resolve()
        if key in seen:
            continue
        seen.add(key)
        for suffix in (".npz", ".pt", ".bin", ".safetensors"):
            cand = root / "checkpoints" / f"huggingface_clip{suffix}"
            if cand.exists():
                return cand
    hub_roots = [Path(os.environ.get("HF_HOME", "~/.cache/huggingface")).expanduser() / "hub"]
    if os.environ.get("HF_HUB_CACHE"):
        hub_roots.insert(0, Path(os.environ["HF_HUB_CACHE"]).expanduser())
    for hub in hub_roots:
        snaps = hub / "models--openai--clip-vit-base-patch32" / "snapshots"
        if snaps.is_dir():
            for snap in sorted(snaps.iterdir(), reverse=True):
                for fname in ("model.safetensors", "pytorch_model.bin"):
                    if (snap / fname).exists():
                        return snap / fname
    return None


def probe_assets():
    """Locate the SURVEY §6 parity assets at well-known paths.

    Returns {"data_root": str|None, "assets": {name: path|None},
    "runnable": [config dicts]} without importing torch (cheap to call)."""
    roots = []
    if os.environ.get("LEMON_TPU_DATA_ROOT"):
        roots.append(Path(os.environ["LEMON_TPU_DATA_ROOT"]).expanduser())
    roots += [Path(r).expanduser() for r in _CANDIDATE_ROOTS]

    found = {}
    for name, files in _ASSET_FILES.items():
        found[name] = None
        for root in roots:
            if all((root / f).exists() for f in files):
                found[name] = root
                break
            tgz = _ASSET_TARBALLS.get(name)
            if tgz and (root / tgz).exists():  # loader auto-extracts
                found[name] = root
                break

    # All dataset assets must share one root (the loader reads one
    # LEMON_TPU_DATA_ROOT); prefer the root holding cifar10.
    data_root = found["cifar10"] or found["cifar100"]
    if data_root is not None:
        for name, root in found.items():
            if root is not None and root != data_root:
                found[name] = None

    ckpt = _find_hf_clip_checkpoint(
        extra_roots=[str(data_root)] if data_root is not None else ()
    )
    configs = []
    if ckpt is not None:
        for ds, human in (("cifar10", "cifar10n"), ("cifar100", "cifar100n")):
            if found[ds] is None:
                continue
            configs.append({"dataset": ds, "noise_type": "symmetric"})
            configs.append({"dataset": ds, "noise_type": "asymmetric"})
            if found[human] is not None:
                configs.append({"dataset": ds, "noise_type": "real"})
    return {
        "data_root": str(data_root) if data_root else None,
        "checkpoint": str(ckpt) if ckpt else None,
        "assets": {k: (str(v) if v else None) for k, v in found.items()},
        "manifest": {k: v for k, v in _ASSET_FILES.items()},
        "runnable": configs,
    }


def _auto(args):
    probe = probe_assets()
    print(json.dumps(probe, indent=2))
    if not probe["runnable"]:
        print(
            "parity_check --auto: no runnable configuration (see manifest above; "
            "DATASOURCES.md documents where each file comes from). Exiting 0.",
        )
        return
    if probe["data_root"]:
        os.environ["LEMON_TPU_DATA_ROOT"] = probe["data_root"]
    if probe["checkpoint"]:
        os.environ["LEMON_TPU_CKPT_HUGGINGFACE_CLIP"] = probe["checkpoint"]
    out_root = Path(args.output_dir)
    reports = []
    for cfg in probe["runnable"]:
        sub = out_root / f"{cfg['dataset']}_{cfg['noise_type']}"
        argv = [
            "--output_dir", str(sub),
            "--dataset", cfg["dataset"],
            "--noise_type", cfg["noise_type"],
            "--noise_level", str(args.noise_level),
            "--knn_k", str(args.knn_k),
            "--seed", str(args.seed),
            "--data_seed", str(args.data_seed),
        ]
        argv += ["--platform", args.platform]
        print(f"[parity_check --auto] running {cfg}", flush=True)
        # Per-config isolation: one failing configuration must not discard
        # the completed reports of a multi-hour sweep — record the error
        # and keep going; parity_auto.json is always written.
        try:
            main(argv)
            reports.append(json.loads((sub / "parity.json").read_text()))
        except (Exception, SystemExit) as e:  # noqa: BLE001
            print(f"[parity_check --auto] {cfg} FAILED: {e!r}", flush=True)
            reports.append({**cfg, "error": repr(e)})
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "parity_auto.json").write_text(json.dumps(reports, indent=2))
    print(json.dumps({"auto_reports": reports}))
    if any("error" in r for r in reports):
        sys.exit(f"parity_check --auto: {sum('error' in r for r in reports)} of "
                 f"{len(reports)} configurations failed (see parity_auto.json)")


def main(argv=None):
    p = argparse.ArgumentParser(description="lemon_tpu_torch AUROC parity check")
    p.add_argument("--auto", action="store_true",
                   help="probe well-known asset paths and run every runnable config")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--dataset", default="cifar10", choices=["cifar10", "cifar100"])
    p.add_argument("--noise_type", default="symmetric", choices=["real", "symmetric", "asymmetric"])
    p.add_argument("--noise_level", type=float, default=0.4)
    p.add_argument("--knn_k", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--reference_auroc", type=float, default=None,
                   help="reference's test AUROC for the same config; asserts |diff| <= tolerance")
    p.add_argument("--tolerance", type=float, default=0.001)
    args = p.parse_args(argv)

    if args.auto:
        if args.output_dir is None:
            args.output_dir = "out/parity_auto"
        return _auto(args)
    if args.output_dir is None:
        p.error("--output_dir is required (or use --auto)")

    ckpt = _find_hf_clip_checkpoint()
    if ckpt is None:
        sys.exit(
            "parity_check needs a real openai/clip-vit-base-patch32 checkpoint "
            "(set LEMON_TPU_CKPT_HUGGINGFACE_CLIP); refusing to report an AUROC "
            "from random weights."
        )
    # Export so the model registry resolves the same file (it only checks
    # the env var and <data_root>/checkpoints, not the HF hub cache).
    os.environ["LEMON_TPU_CKPT_HUGGINGFACE_CLIP"] = str(ckpt)

    from lemon_tpu_torch.cli.run_lemon import main as run_lemon_main

    run_lemon_main([
        "--output_dir", args.output_dir,
        # Reference-identical optimizer path: full grid under the fminbound
        # objective (lib/metrics/utils.py:173-190), so the selected hparams
        # are bit-comparable for the 0.001-AUROC acceptance bar.
        "--strict_hparam_parity",
        "--dataset", args.dataset,
        "--noise_type", args.noise_type,
        "--noise_level", str(args.noise_level),
        "--knn_k", str(args.knn_k),
        "--seed", str(args.seed),
        "--data_seed", str(args.data_seed),
        "--platform", args.platform,
    ])

    import pickle

    with open(Path(args.output_dir) / "res.pkl", "rb") as f:
        agg = pickle.load(f)["agg_results"]["know_val_labels"]
    auroc = agg["test"]["AUROC"]
    report = {"dataset": args.dataset, "noise_type": args.noise_type,
              "noise_level": args.noise_level, "knn_k": args.knn_k,
              "test_AUROC": auroc, "val_AUROC": agg["val"]["AUROC"]}
    if args.reference_auroc is not None:
        report["reference_AUROC"] = args.reference_auroc
        report["abs_diff"] = abs(auroc - args.reference_auroc)
        report["within_tolerance"] = report["abs_diff"] <= args.tolerance
    print(json.dumps(report))
    (Path(args.output_dir) / "parity.json").write_text(json.dumps(report))
    if args.reference_auroc is not None and not report["within_tolerance"]:
        sys.exit(f"AUROC parity FAILED: |{auroc} - {args.reference_auroc}| > {args.tolerance}")


if __name__ == "__main__":
    main()
