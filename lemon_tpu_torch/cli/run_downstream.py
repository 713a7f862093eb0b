"""Downstream filter-then-train CLI (port of lemon_tpu/cli/run_downstream.py;
reference train_downstream_classification.py).

Consumes a detector run's scores, filters the training split, fine-tunes a
classifier or a captioner, evaluates:

    python -m lemon_tpu_torch.cli.run_downstream --task classification \\
        --output_dir out/ds --dataset synthetic --scores out/run/dists.npy
    python -m lemon_tpu_torch.cli.run_downstream --task captioning \\
        --output_dir out/dc --dataset synthetic_caption \\
        --scores out/run/know_val_labels_scores.csv --lora

``--epochs 0 --cifar10_corruption_name NAME --eval_checkpoints CKPT ...``
evaluates trained checkpoints (``ckpt.pt``) on a CIFAR-10-C corruption.

Outputs: args.json, out.txt/err.txt, results.json, {val,test}_pred_y.npy,
{val,test}_probs.npy, ckpt.pt, done (the robustness mode: the per-model
prediction npys and results pkls, done). Captioning writes args.json,
out.txt/err.txt, captions.pkl, flip_labels.pkl, detection_scores.npy,
results.json and done; ``--captioner_arch git|blip2`` picks the GIT-style
or the Q-Former captioner, ``--blip2_checkpoint`` a local HF BLIP-2 (OPT)
directory, whose ``config.json`` the port reads itself
(``models/blip2.blip2_config_from_hf``). ``--platform`` is ``cuda`` (the
default; raises without a card) or ``cpu``.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

import numpy as np
import torch

def build_parser():
    p = argparse.ArgumentParser(description="lemon_tpu_torch downstream training")
    p.add_argument("--task", required=True, choices=["classification", "captioning"])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dataset", default=None,
                   help="default: synthetic (training) / cifar10c (robustness eval mode)")
    p.add_argument("--noise_type", default="symmetric")
    p.add_argument("--noise_level", type=float, default=0.4)
    p.add_argument("--scores", default=None, help="detector dists.npy or scores CSV; omit for no filtering")
    p.add_argument("--percentile", type=float, default=60.0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--lora", action="store_true", help="captioning: train LoRA adapters only")
    p.add_argument("--blip2_checkpoint", default=None, help="captioning: local HF Blip2ForConditionalGeneration dir")
    p.add_argument("--captioner_arch", default="git", choices=["git", "blip2"],
                   help="captioning: GIT-style prefix model or BLIP-2-faithful Q-Former")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; a run never falls back to the CPU by itself")
    p.add_argument("--synthetic_n", type=int, default=300)
    p.add_argument("--model_size", default="tiny", choices=["tiny", "vit_b32"])
    p.add_argument("--cifar10_corruption_name", default=None,
                   help="with --epochs 0: evaluate trained checkpoints on this CIFAR-10-C corruption "
                        "(robustness mode, train_downstream_classification.py:221-233,355-358)")
    p.add_argument("--eval_checkpoints", nargs="*", default=None,
                   help="ckpt.pt files of earlier runs for the robustness evaluation (reference intent: 3 seeds)")
    return p


def main(argv=None):
    """Runs one task; returns its results (per model in the robustness mode)."""
    args = build_parser().parse_args(argv)

    from lemon_tpu_torch.core.device import resolve_device
    from lemon_tpu_torch.core.io import dump_args, env_banner, redirect_output
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.data.labels import LABEL_SETS
    from lemon_tpu_torch.models.clip import ClipConfig
    from lemon_tpu_torch.train.downstream import DownstreamConfig, evaluate_cifar10c, load_detector_scores, train_downstream

    device = resolve_device(args.platform)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    redirect_output(out_dir)
    print(env_banner(device))
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    dump_args(out_dir, vars(args))
    model_cfg = ClipConfig.tiny() if args.model_size == "tiny" else ClipConfig.vit_b32()

    if args.cifar10_corruption_name and args.epochs == 0:
        # robustness inference: no training, no filtering — evaluate existing
        # checkpoints on the corrupted test set. cifar10c reads the real
        # CIFAR-10-C npys; a synthetic classification set's test split
        # stands in for it (test fixtures only)
        dataset = args.dataset or "cifar10c"
        if not args.eval_checkpoints:
            raise SystemExit("--epochs 0 robustness mode needs --eval_checkpoints")
        if not (dataset == "cifar10c"
                or (dataset.startswith("synthetic") and not dataset.startswith("synthetic_caption"))):
            raise SystemExit(f"robustness mode evaluates cifar10c (or a synthetic classification stand-in), "
                             f"not {dataset}")
        cfg = DownstreamConfig(num_classes=len(LABEL_SETS["cifar10"]), batch_size=args.batch_size,
                               seed=args.seed, model_cfg=model_cfg)
        test_split = None
        if dataset.startswith("synthetic"):
            test_split = get_dataset(dataset, args.data_seed, noise_level=0.0, synthetic_n=args.synthetic_n)[2]
        results = evaluate_cifar10c(cfg, args.eval_checkpoints, args.cifar10_corruption_name, out_dir,
                                    test_split=test_split, device=device)
        for mc, r in results.items():
            print(f"model {mc}: avg {r['average_accuracy']:.4f} worst {r['worst_accuracy']:.4f}")
        return results
    if args.cifar10_corruption_name and args.dataset != "cifar10c":
        raise SystemExit(
            "--cifar10_corruption_name with training epochs requires --dataset cifar10c "
            "(train on cifar10, evaluate on the corrupted test set)"
        )

    # captioning needs a caption-bearing dataset; classification's default has no sentences
    default_ds = "synthetic_caption" if args.task == "captioning" else "synthetic"
    splits = dict(zip(("train", "val", "test"), get_dataset(
        args.dataset or default_ds, args.data_seed, noise_level=args.noise_level,
        noise_type=args.noise_type, synthetic_n=args.synthetic_n,
        corruption_name=args.cifar10_corruption_name,
    )))
    scores = load_detector_scores(Path(args.scores), "train") if args.scores else None
    if args.task == "captioning":
        return _captioning(args, splits, scores, out_dir, device)
    n_classes = len(LABEL_SETS.get(args.dataset or "synthetic", LABEL_SETS["cifar10"]))
    cfg = DownstreamConfig(
        num_classes=n_classes, percentile=args.percentile, epochs=args.epochs,
        batch_size=args.batch_size, learning_rate=args.lr,
        freeze_backbone=args.freeze_backbone, seed=args.seed, model_cfg=model_cfg,
    )
    results = train_downstream(cfg, splits, detector_scores=scores, out_dir=out_dir, device=device)
    print(f"test accuracy {results['test']['accuracy']:.4f} "
          f"worst-group {results['test']['worst_group_accuracy']:.4f}")
    return results


def _captioning(args, splits, scores, out_dir: Path, device: torch.device):
    """The captioning branch (lemon_tpu/cli/run_downstream.py:145-172)."""
    import dataclasses
    import json

    from lemon_tpu_torch.models.blip2 import blip2_config_from_hf
    from lemon_tpu_torch.models.captioner import CaptionerConfig
    from lemon_tpu_torch.models.qformer import QFormerConfig
    from lemon_tpu_torch.train.captioning import CaptionTrainConfig, train_captioner

    if args.blip2_checkpoint:
        hf = json.loads((Path(args.blip2_checkpoint) / "config.json").read_text())
        mc = blip2_config_from_hf(hf, lora_rank=16 if args.lora else 0)
    else:
        cfg_cls = QFormerConfig if args.captioner_arch == "blip2" else CaptionerConfig
        mc = cfg_cls.tiny() if args.model_size == "tiny" else cfg_cls.base()
        if args.lora:
            mc = dataclasses.replace(mc, lora_rank=16)
    cfg = CaptionTrainConfig(percentile=args.percentile, epochs=args.epochs, batch_size=args.batch_size,
                             learning_rate=args.lr, seed=args.seed, lora_only=args.lora, model_cfg=mc,
                             blip2_checkpoint=args.blip2_checkpoint)
    results = train_captioner(cfg, splits, detector_scores=scores, out_dir=out_dir, device=device)
    print(f"best val loss {results['val_loss_best']:.4f}")
    return results


if __name__ == "__main__":
    main()
