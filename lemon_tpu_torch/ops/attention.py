"""Flash attention over the CLIP towers' (B, L, H, D) layout (K3).

Port of ``lemon_tpu/ops/attention.py`` (``flash_attention``). One kernel
computes ``q @ k^T`` with ``q`` scaled by ``D**-0.5`` first, the optionally
causal online softmax and the ``@ v`` contraction without writing the
(L, L) logits to device memory; running max, normaliser and accumulator stay
in fp32. The CUDA kernel is ``csrc/attention.cu``: forward only, like the TPU
kernel (the encoder is frozen), for head dims 32, 64 and 128.

:func:`flash_attention_plain` is the counterpart of the JAX package's
``reference_attention``: the CPU tests and ``chip_smoke.py`` use it, nothing
on the card's path does.
"""

from __future__ import annotations

import torch

from lemon_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` (any device)."""
    _check(q, k, v)
    d = q.shape[-1]
    logits = torch.einsum("blhd,bmhd->bhlm", q * d ** -0.5, k)
    if causal:
        l = q.shape[1]
        keep = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -torch.inf)
    return torch.einsum("bhlm,bmhd->blhd", torch.softmax(logits, dim=-1), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Attention of fp32 ``q``, ``k``, ``v`` (B, L, H, D) -> (B, L, H, D)
    contiguous, D in {32, 64, 128}; ``causal`` lets query i see keys j <= i.
    Forward only: raises if an input requires grad. Strided views such as
    the per-head split of a fused QKV projection are read in place when the
    three share their strides and (H, D) is contiguous within a token. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (``flash_attention.launches`` counts the launches)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, l, h, d = q.shape
    if not (q.stride() == k.stride() == v.stride() and q.stride(3) == 1 and q.stride(2) == d):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, l, h, d), dtype=torch.float32, device=q.device)
    code = _build.library().lemon_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, h, d,
        q.stride(0), q.stride(1), d ** -0.5, int(causal), _build.stream_handle(q),
    )
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if any(x.requires_grad for x in (q, k, v)):
        raise ValueError("flash_attention: forward only (the kernel has no backward); got an input that requires grad")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: need q, k, v of one (B, L, H, D) shape, got {q.shape}, {k.shape}, {v.shape}")
    if any(x.dtype != torch.float32 or x.device != q.device for x in (q, k, v)):
        raise ValueError("flash_attention: inputs must be float32 on one device")
    b, l, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if not 0 < l <= 65535 * 64 or not 0 < b * h < 2**31:  # the launch grid's bounds
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
