"""LEMoN detection CLI — the flags and output files of
``lemon_tpu.cli.run_lemon`` (reference: run_lemon.py:34-58).

Example:
    python -m lemon_tpu_torch.cli.run_lemon --output_dir out/exp1 \
        --dataset cifar10 --noise_type symmetric --noise_level 0.4

Outputs: args.json, out.txt/err.txt, res.pkl, {criteria}_scores.csv, done;
out.txt's last line counts the process's kernel launches
(:func:`kernel_launches`).

Differences from the JAX CLI: ``--platform`` is ``cuda`` (default) or
``cpu`` and a run without a GPU raises unless ``--platform cpu`` is given;
``--mesh DATAxMODEL`` runs one process per device (NCCL on the card, gloo on
the CPU; under ``torchrun``, or a world of one without it): batches and the
database are sharded over DATA and replicated over MODEL, as in the JAX CLI,
and global rank 0 writes the output files; ``--clip_model`` also takes
``rn50``, a registry model the JAX CLI does not list. The towers' precision
mode comes from ``LEMON_TPU_PRECISION`` (``fp32``, the default, ``bf16``,
``int8`` or ``int8_static``; ``biomed_clip`` runs in fp32), as in the JAX
CLI. The towers run the plain attention route, as the JAX CLI runs its XLA
one: neither CLI has an attention flag. Repeated ``main`` calls in one
process share an encoder and, under ``--embedding_cache``, the device
embeddings (``detect.py``).
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LEMoN (PyTorch/CUDA)")
    p.add_argument("--exp_name", type=str)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument(
        "--dataset",
        type=str,
        default="cifar100",
        choices=[
            "cifar10", "cifar100", "flickr30k", "mscoco", "mimiccxr_caption", "mmimdb",
            "cifar10_full", "cifar100_full", "mini_imagenet", "stanford_cars", "cc3m",
            "synthetic", "synthetic_caption", "synthetic_caption_stream",
        ],
    )
    p.add_argument("--noise_type", type=str, default="real",
                   choices=["real", "asymmetric", "symmetric", "random", "noun", "cat"])
    p.add_argument("--noise_level", type=float, default=0.4)
    p.add_argument("--dist_type", type=str, default="cosine", choices=["cosine", "euclidean"])
    p.add_argument("--normalize_d1", action="store_true")
    p.add_argument("--clip_model", type=str, default="huggingface_clip",
                   choices=["huggingface_clip", "biomed_clip", "mimic_clip_from_scratch_random",
                            "mimic_clip_from_scratch_cat", "chexzero", "cc3m_clip_from_scratch", "tiny", "rn50"])
    p.add_argument("--knn_k", default=5, type=int)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--data_seed", default=0, type=int)
    p.add_argument("--compr_dataset_size_limit", default=50000, type=int)
    p.add_argument("--ablation", default="none",
                   choices=["none", "tau_1", "tau_2", "tau_1_2", "beta", "gamma",
                            "multimodal_baseline", "d1", "only_gamma", "only_beta"])
    p.add_argument("--use_discrete_for_text", action="store_true")
    p.add_argument("--real_dataset", action="store_true")
    p.add_argument("--custom_cifar_prompt", default=None)
    p.add_argument("--subset_val_set", default=-1, type=int)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_hparam_optim", action="store_true")
    p.add_argument("--strict_hparam_parity", action="store_true",
                   help="evaluate every hparam grid point under the fminbound objective "
                        "like lib/metrics/utils.py:173-190 (slower; bit-comparable hparams)")
    # framework extensions
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; a run never falls back to the CPU by itself")
    p.add_argument("--mesh", default=None,
                   help="mesh shape as DATAxMODEL, e.g. 8x1 (one process per device; sharded over DATA, "
                        "replicated over MODEL)")
    p.add_argument("--knn_tile", default=0, type=int,
                   help="DB tile rows (rounded up to a multiple of 128); 0 = adaptive")
    p.add_argument("--knn_precision", default="auto", choices=["auto", "highest", "high"],
                   help="kNN score precision: 'highest' = fp32 products on the CPU, six bf16 products "
                        "(the TPU's HIGHEST) on the card; 'high' = bf16x3; "
                        "'auto' = bf16x3 unless --strict_hparam_parity")
    p.add_argument("--embedding_cache", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--synthetic_n", default=600, type=int)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from lemon_tpu_torch.core.device import resolve_device
    from lemon_tpu_torch.core.io import dump_args, env_banner, mark_done, redirect_output
    from lemon_tpu_torch.core.mesh import get_mesh, parse_mesh
    from lemon_tpu_torch.detect import DetectionConfig, run_detection

    device = resolve_device(args.platform)
    mesh_shape = parse_mesh(args.mesh) if args.mesh else None
    lead = True  # the rank that writes the run's files
    if mesh_shape is not None:
        mesh = get_mesh(*mesh_shape, platform=args.platform)
        device, lead = mesh.device, mesh.lead
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if lead and not args.debug:
        redirect_output(out_dir)

    print(env_banner(device))
    print("Args:")
    for key, val in sorted(vars(args).items()):
        print(f"\t{key}: {val}")

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    if lead:
        dump_args(out_dir, vars(args))

    cfg = DetectionConfig(
        dataset=args.dataset,
        noise_type=args.noise_type,
        noise_level=args.noise_level,
        dist_type=args.dist_type,
        normalize_d1=args.normalize_d1,
        clip_model=args.clip_model,
        knn_k=args.knn_k,
        batch_size=args.batch_size,
        seed=args.seed,
        data_seed=args.data_seed,
        compr_dataset_size_limit=args.compr_dataset_size_limit,
        ablation=args.ablation,
        use_discrete_for_text=args.use_discrete_for_text,
        real_dataset=args.real_dataset,
        custom_cifar_prompt=args.custom_cifar_prompt,
        subset_val_set=args.subset_val_set,
        debug=args.debug,
        skip_train=args.skip_train,
        skip_hparam_optim=args.skip_hparam_optim,
        strict_hparam_parity=args.strict_hparam_parity,
        synthetic_n=args.synthetic_n,
        knn_tile=args.knn_tile,
        knn_precision=args.knn_precision,
        mesh_shape=mesh_shape,
        embedding_cache=args.embedding_cache,
        checkpoint=args.checkpoint,
        platform=args.platform,
    )
    run_detection(cfg, out_dir)
    if lead:
        print("kernel launches in this process: " + json.dumps(kernel_launches()))
        mark_done(out_dir)


def kernel_launches() -> dict:
    """This process's launches of the kernels a detection can reach, from
    the wrappers' counts: K1 by precision, K2, K3 fp32 and bf16. A run in a
    process of its own (a sweep's job) reports its path's launches so."""
    from lemon_tpu_torch.ops import attention, scoremax, topk

    highest, bf16 = scoremax.scores_blockmax.launches_highest, attention.flash_attention.launches_bf16
    return {"scores_blockmax": scoremax.scores_blockmax.launches - highest, "scores_blockmax_highest": highest,
            "topk": topk.topk.launches, "flash_attention": attention.flash_attention.launches - bf16,
            "flash_attention_bf16": bf16}


if __name__ == "__main__":
    from lemon_tpu_torch.core.mesh import shutdown

    try:
        main()
    finally:
        shutdown()
