"""Exact row-wise top-k with the FAISS tie rule (K2).

Port of ``lemon_tpu/ops/topk.py`` (``pallas_topk``). Values come out in
descending order with ties to the lower column, and ``-inf`` entries are
taken in ascending column order, exactly like ``jax.lax.top_k``. Every top-k
in the port's kNN goes through here: ``torch.topk`` does not promise the
order of ties on CUDA. The CUDA kernel is ``csrc/topk.cu``; unlike the TPU
kernel it has no bound on k below the row width. It has two variants, one
launch per call: ``"warp"`` (one warp per row, the row in registers, W up to
1024) and ``"radix"`` (one block per row, a threshold select);
``variant="auto"`` picks by (W, k) as the kernel's entry point does.
"""

from __future__ import annotations

import torch

from lemon_tpu_torch.ops import _build

VARIANTS = {"auto": 0, "warp": 1, "radix": 2}
WARP_MAX_W = 1024


def topk_plain(x: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`topk` (any device)."""
    _check(x, k)
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].contiguous()


def topk(x: torch.Tensor, k: int, variant: str = "auto"):
    """(values (B, k) float32, indices (B, k) int64) of the k largest entries
    of each row of ``x`` (B, W), contiguous float32, ``0 < k <= W``.
    NaN is not supported; -0.0 and +0.0 tie. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``topk.launches`` counts the
    launches). ``variant`` forces a kernel variant (for measurement)."""
    _check(x, k)
    if variant not in VARIANTS or (variant == "warp" and x.shape[1] > WARP_MAX_W):
        raise ValueError(f"topk: variant {variant!r} does not take W={x.shape[1]} (variants {tuple(VARIANTS)})")
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk: unsupported device {x.device}")
    b, w = x.shape
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=x.device)
    code = _build.library().lemon_topk(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, w, k, VARIANTS[variant], _build.stream_handle(x)
    )
    _build.check(code, "topk")
    topk.launches += 1
    return vals, idx


topk.launches = 0


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"topk: need a contiguous 2-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    b, w = x.shape
    if not 0 < k <= w:
        raise ValueError(f"topk: need 0 < k <= W={w}, got k={k}")
    if not 0 < b < 2**31 or w >= 2**31:
        raise ValueError(f"topk: unsupported shape {tuple(x.shape)}")
