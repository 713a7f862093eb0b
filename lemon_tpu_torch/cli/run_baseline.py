"""Baseline CLI: the flags and output files of ``lemon_tpu.cli.run_baseline``.

The reference ships one script per baseline (lib/baselines/run_clip_sim.py,
train_zero_shot_clip_baseline.py, discrepancy_baseline.py, run_deepknn.py,
training_dependent_baselines.py); here they share one entry point:

    python -m lemon_tpu_torch.cli.run_baseline --baseline discrepancy \
        --method dis_x --dataset mscoco --noise_type cat --output_dir out/d

Outputs: args.json, out.txt/err.txt, res.pkl, scores.csv, done, and each
baseline's own ``.npy`` files. The parser is ``run_lemon``'s, so
``--platform`` is ``cuda`` (the default; raises without a GPU) or ``cpu``,
and the towers' precision mode comes from ``LEMON_TPU_PRECISION``. ``aum``
and ``datamap`` train a classifier whose backbone ``--img_base_name`` picks
(``clip``: the tiny CLIP tower; ``resnet50``: the torchvision-layout
ResNet-50; ``vit-base-patch16-224``: the google ViT-B/16; ``*_tiny``: test
scale) and also write the per-epoch pkls. ``capfilt`` scores pairs with a
BLIP ITM tower read from ``--itm_checkpoint`` (a local ``save_pretrained``
directory; ``lemon_tpu_torch/models/blip_itm.py``) or, without one, with
the CLIP proxy head, and also writes full_loss_dict.pkl, flip_labels.pkl
and runtime.npy.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

import numpy as np
import torch

BASELINES = ("clip_sim", "zero_shot", "discrepancy", "deepknn", "capfilt", "aum", "datamap")
# run_lemon flags with no baseline semantics: a non-default value is refused
RUN_LEMON_ONLY = (
    "normalize_d1", "ablation", "use_discrete_for_text", "real_dataset",
    "subset_val_set", "mesh", "skip_hparam_optim",
    "strict_hparam_parity",
)


def build_parser() -> argparse.ArgumentParser:
    from lemon_tpu_torch.cli.run_lemon import build_parser as lemon_parser

    p = lemon_parser()
    p.description = "lemon_tpu_torch baselines"
    p.add_argument("--baseline", required=True, choices=BASELINES)
    p.add_argument("--method", default="", help="discrepancy: dis_y|dis_x|div_y|div_x")
    p.add_argument("--temperature", type=float, default=1.0, help="zero-shot softmax temperature")
    p.add_argument("--epochs", type=int, default=10, help="aum/datamap training epochs")
    p.add_argument("--img_base_name", default="clip",
                   choices=["clip", "resnet50", "vit-base-patch16-224", "resnet50_tiny", "vit_tiny"],
                   help="aum/datamap classifier backbone (get_img_base, lib/models/utils.py:49-61); "
                        "*_tiny are test-scale variants")
    p.add_argument("--itm_checkpoint", default=None,
                   help="capfilt: local BLIP-ITM checkpoint dir (falls back to the CLIP proxy head)")
    return p


def classifier_config(img_base_name: str):
    """The aum/datamap backbone of ``--img_base_name`` (get_img_base,
    lib/models/utils.py:49-61); None is the tiny CLIP tower."""
    if img_base_name.startswith("resnet50"):
        from lemon_tpu_torch.models.classifier import TvResNetSpec

        return TvResNetSpec.tiny() if img_base_name.endswith("_tiny") else TvResNetSpec()
    if img_base_name.startswith("vit"):
        from lemon_tpu_torch.models.torch_backbones import GoogleViTConfig

        return GoogleViTConfig.tiny() if img_base_name.endswith("_tiny") else GoogleViTConfig()
    return None


def main(argv=None):
    """Runs one baseline; returns its result (the in-memory ``res``)."""
    parser = build_parser()
    args = parser.parse_args(argv)

    from lemon_tpu_torch.baselines.common import BaselineConfig
    from lemon_tpu_torch.core.device import resolve_device
    from lemon_tpu_torch.core.io import dump_args, env_banner, mark_done, redirect_output

    device = resolve_device(args.platform)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not args.debug:
        redirect_output(out_dir)
    print(env_banner(device))
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    dump_args(out_dir, vars(args))

    # the parser is run_lemon's for flag-name familiarity, but these flags
    # have no baseline semantics: refuse non-default values rather than let
    # args.json record options that did nothing
    for flag in RUN_LEMON_ONLY:
        default = parser.get_default(flag)  # stays in sync with run_lemon's parser
        if getattr(args, flag, default) != default:
            raise SystemExit(f"--{flag} is a run_lemon flag with no effect on baselines; remove it")

    cfg = BaselineConfig(
        dataset=args.dataset, noise_type=args.noise_type, noise_level=args.noise_level,
        dist_type=args.dist_type, clip_model=args.clip_model, knn_k=args.knn_k,
        batch_size=args.batch_size, seed=args.seed, data_seed=args.data_seed,
        debug=args.debug, skip_train=args.skip_train, synthetic_n=args.synthetic_n,
        knn_tile=args.knn_tile, checkpoint=args.checkpoint,
        method=args.method, temperature=args.temperature,
        itm_checkpoint=args.itm_checkpoint,
        # content-keyed, shared with run_lemon runs over the same data
        embedding_cache=args.embedding_cache,
        platform=args.platform,
    )
    if args.baseline in ("aum", "datamap"):
        from lemon_tpu_torch.baselines.training_dependent import run_training_dependent

        cfg.method = args.baseline
        res = run_training_dependent(cfg, out_dir, epochs=args.epochs, model_cfg=classifier_config(args.img_base_name))
        mark_done(out_dir)
        return res
    if args.baseline == "clip_sim":
        from lemon_tpu_torch.baselines.clip_sim import run_clip_sim as runner
    elif args.baseline == "zero_shot":
        from lemon_tpu_torch.baselines.zero_shot import run_zero_shot_logits as runner
    elif args.baseline == "discrepancy":
        from lemon_tpu_torch.baselines.discrepancy import run_discrepancy as runner
    elif args.baseline == "capfilt":
        from lemon_tpu_torch.baselines.capfilt import run_capfilt as runner
    else:
        from lemon_tpu_torch.baselines.deepknn import run_deepknn as runner
    res = runner(cfg, out_dir)
    mark_done(out_dir)
    return res


if __name__ == "__main__":
    main()
