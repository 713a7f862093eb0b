"""Contrastive CLIP training CLI (port of lemon_tpu/cli/train_clip.py;
reference train_clip_from_scratch.py).

Trains a CLIP from scratch on a captioning dataset (MIMIC-CXR at context
256, CC3M at 77), with the detection-driven CC3M filtering mode
(``--cc3m_filtering`` names a prior LEMoN run). Random-resized crops on the
host, preprocessing on the device, data parallelism with global-batch
InfoNCE under ``--mesh DxM``, tensor parallelism over the model axis when
``M > 1`` (Megatron's split of the towers' blocks), torch checkpoints under
``<output_dir>/ckpt``.

    python -m lemon_tpu_torch.cli.train_clip --output_dir out/clip --dataset cc3m
    torchrun --nproc_per_node 4 -m lemon_tpu_torch.cli.train_clip ... --mesh 4x1
    torchrun --nproc_per_node 4 -m lemon_tpu_torch.cli.train_clip ... --mesh 2x2

Outputs: args.json, out.txt/err.txt, ckpt/<step>/state.pt, done (global
rank 0).
``--platform`` is ``cuda`` (the default; raises without a card) or ``cpu``.
"""

from __future__ import annotations

import argparse
import math
import random
from pathlib import Path

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="lemon_tpu_torch CLIP trainer")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dataset", default="cc3m", choices=["cc3m", "mimiccxr_caption", "synthetic_caption"])
    p.add_argument("--noise_type", default="random")
    p.add_argument("--noise_level", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--total_steps", type=int, default=100_000)
    p.add_argument("--save_interval", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="bf16 = bf16 compute, fp32 master weights and LayerNorm")
    p.add_argument("--context_length", type=int, default=None)
    p.add_argument("--cc3m_filtering", default=None, help="prior LEMoN run dir")
    p.add_argument("--cc3m_filtering_n", type=int, default=-1)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; a run never falls back to the CPU by itself")
    p.add_argument("--mesh", default=None,
                   help="DATAxMODEL, e.g. 8x1 (data parallelism, one process per device) or 4x2 "
                        "(tensor parallelism over MODEL neighbouring processes)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in output_dir/ckpt")
    p.add_argument("--synthetic_n", type=int, default=600)
    p.add_argument("--model_size", default="vit_b16", choices=["vit_b16", "vit_b32", "tiny"])
    return p


def _rrc_box(rng, h, w, scale=(0.3, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """torchvision ``RandomResizedCrop.get_params``: 10 attempts of (area,
    log-uniform aspect) draws, then the centre crop with the ratio clamped.
    Returns (top, left, crop_h, crop_w)."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            return rng.integers(0, h - ch + 1), rng.integers(0, w - cw + 1), ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


class BatchStream:
    """Shuffled epochs of ``{'pixels', 'tokens'}`` with RandomResizedCrop
    (scale 0.3-1, torchvision's draws; train_clip_from_scratch.py:116-121):
    each crop is resized bilinearly with PIL to the model input, then
    preprocessed on ``device``; tokens come from the CLIP BPE.

    The crop RNG of each slot is keyed on (seed, global batch index, slot),
    so ``skip(n)`` fast-forwards a resume by replaying only the shuffles,
    and the crops equal an uninterrupted run's. With a ``mesh`` the stream
    builds only this rank's rows of each batch, drawing their crops with
    their slots in the whole batch, so the pixels equal one process's; the
    ranks of one model group build the same rows.
    ``last_boxes`` holds the crop boxes of the last batch built."""

    def __init__(self, split, tokenizer_ctx, batch_size, image_size, seed, augment=True, device=None, mesh=None):
        from lemon_tpu_torch.core.device import resolve_device

        if mesh is not None and batch_size % mesh.data:
            raise ValueError(f"batch_size {batch_size} is not a multiple of the data axis ({mesh.data})")
        self.split = split
        self.tokenizer_ctx = tokenizer_ctx
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.augment = augment
        self.device = resolve_device("cuda") if device is None else device
        per = batch_size if mesh is None else batch_size // mesh.data
        self.rows = (0, batch_size) if mesh is None else (mesh.rank * per, (mesh.rank + 1) * per)
        self.last_boxes = []
        self._order_rng = np.random.default_rng(seed)
        self._order = None
        self._pos = 0
        self._step = 0

    def _next_idx(self):
        n = len(self.split)
        per_epoch = n // self.batch_size
        if per_epoch == 0:
            raise ValueError(f"split of {n} rows is smaller than batch_size={self.batch_size}")
        if self._order is None or self._pos >= per_epoch:
            self._order = self._order_rng.permutation(n)
            self._pos = 0
        start = self._pos * self.batch_size
        self._pos += 1
        return self._order[start : start + self.batch_size]

    def skip(self, n_batches: int) -> None:
        for _ in range(int(n_batches)):
            self._next_idx()
            self._step += 1

    def __iter__(self):
        return self

    def __next__(self):
        from PIL import Image

        from lemon_tpu_torch.data.datasets import load_images
        from lemon_tpu_torch.models.tokenizer import tokenize_batch
        from lemon_tpu_torch.ops.image import preprocess_device

        lo, hi = self.rows
        idx = self._next_idx()[lo:hi]
        size = self.image_size
        self.last_boxes = []
        if self.augment:
            crops = []
            for slot, raw in enumerate(load_images(self.split, idx, stack=False), start=lo):
                rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._step, slot]))
                top, left, ch, cw = _rrc_box(rng, raw.shape[0], raw.shape[1])
                self.last_boxes.append((int(top), int(left), ch, cw))
                im = Image.fromarray(raw[top : top + ch, left : left + cw]).resize((size, size), Image.BILINEAR)
                crops.append(np.asarray(im, np.uint8))
            images = np.stack(crops)
        else:
            images = load_images(self.split, idx, decode_size=size)
        pixels = preprocess_device(images, size=size, device=self.device)
        tokens = tokenize_batch(list(self.split.sentence[idx]), self.tokenizer_ctx)
        self._step += 1
        return {"pixels": pixels, "tokens": tokens}


def main(argv=None):
    """Train; returns the final :class:`~lemon_tpu_torch.train.contrastive.TrainState`."""
    args = build_parser().parse_args(argv)

    from lemon_tpu_torch.core.device import resolve_device
    from lemon_tpu_torch.core.io import dump_args, env_banner, mark_done, redirect_output
    from lemon_tpu_torch.core.mesh import get_mesh, parse_mesh
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.clip import ClipConfig
    from lemon_tpu_torch.train.contrastive import TrainConfig, create_train_state, train_loop
    from lemon_tpu_torch.train.filtering import filter_indices_from_run

    device = resolve_device(args.platform)
    mesh = get_mesh(*parse_mesh(args.mesh), platform=args.platform) if args.mesh else None
    if mesh is not None:
        device = mesh.device
    lead = mesh is None or mesh.lead  # the rank that writes the run's files
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if lead:
        redirect_output(out_dir)
    print(env_banner(device))
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    if lead:
        dump_args(out_dir, vars(args))

    train, _, _ = get_dataset(args.dataset, args.data_seed, noise_level=args.noise_level,
                              noise_type=args.noise_type, synthetic_n=args.synthetic_n)
    if args.cc3m_filtering:
        if args.cc3m_filtering_n <= 0:
            raise ValueError("--cc3m_filtering needs --cc3m_filtering_n > 0")
        train = train.subset(np.asarray(filter_indices_from_run(args.cc3m_filtering, args.cc3m_filtering_n)))
    print(f"Size of training set: {len(train)}")

    ctx = args.context_length or (256 if args.dataset == "mimiccxr_caption" else 77)
    if args.model_size == "tiny":
        model_cfg = ClipConfig.tiny()
    elif args.model_size == "vit_b32":
        model_cfg = ClipConfig.vit_b32()
    else:
        model_cfg = ClipConfig.vit_b16(embed_dim=768, context_length=ctx)

    tcfg = TrainConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay, optimizer=args.optimizer,
        warmup_steps=args.warmup_steps, total_steps=args.total_steps,
        batch_size=args.batch_size, save_interval=args.save_interval, seed=args.seed,
        precision=args.precision,
    )
    model, state = create_train_state(model_cfg, tcfg, mesh=mesh, device=device)
    batches = BatchStream(train, model_cfg.context_length, args.batch_size, model_cfg.image_resolution,
                          args.seed, device=device, mesh=mesh)
    state = train_loop(model, state, batches, tcfg, mesh=mesh, ckpt_dir=out_dir / "ckpt", resume=args.resume)
    if lead:
        mark_done(out_dir)
    return state


if __name__ == "__main__":
    from lemon_tpu_torch.core.mesh import shutdown

    try:
        main()
    finally:
        shutdown()
