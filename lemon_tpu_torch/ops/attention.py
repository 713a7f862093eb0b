"""Flash attention over the CLIP towers' (B, L, H, D) layout (K3).

Port of ``lemon_tpu/ops/attention.py`` (``flash_attention``). One kernel
computes ``q @ k^T`` with ``q`` scaled by ``D**-0.5`` first, the optionally
causal online softmax and the ``@ v`` contraction without writing the
(L, L) logits to device memory; running max, normaliser and accumulator stay
in fp32. The CUDA kernel is ``csrc/attention.cu``: forward only, like the TPU
kernel (the encoder is frozen), for head dims 32, 64 and 128. It runs both
products on the tensor cores in 3xTF32 (``hi.hi + hi.lo + lo.hi`` of TF32
splits, accumulated in fp32).

:func:`flash_attention_plain` is the counterpart of the JAX package's
``reference_attention`` and the kernel's yardstick;
:func:`flash_attention_3xtf32_plain` repeats the kernel's precision scheme
in plain fp32 arithmetic. The CPU tests and ``chip_smoke.py`` use both,
nothing on the card's path does.
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


def split_tf32_plain(x: torch.Tensor):
    """The kernel's split of fp32 ``x`` into TF32 values ``hi + lo``:
    ``hi`` is ``x`` rounded to nearest at 11 significant bits by Veltkamp's
    split (``t = 8193 x``, ``hi = t - (t - x)``, each operation rounded to
    nearest), ``lo = x - hi`` exactly, with at most 12 significant bits, then
    truncated to TF32 (the low 13 mantissa bits cleared), as the tensor core
    reads it. ``|x - hi - lo| <= 2^-22 |x|``."""
    t = x * 8193.0
    hi = t - (t - x)
    lo = (x - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def flash_attention_3xtf32_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """:func:`flash_attention_plain` with the kernel's precision scheme: the
    scaled q, k, the unnormalised probabilities and v split by
    :func:`split_tf32_plain`, each product ``hi.hi + hi.lo + lo.hi`` in fp32
    (``lo.lo`` dropped). Every product of two TF32 values is exact in fp32,
    so this differs from the kernel only in the order of the sums."""
    _check(q, k, v)
    d = q.shape[-1]
    (q_hi, q_lo), (k_hi, k_lo), (v_hi, v_lo) = (split_tf32_plain(x) for x in (q * d ** -0.5, k, v))

    def three(eq, a_hi, a_lo, b_hi, b_lo):
        return torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi)

    logits = three("blhd,bmhd->bhlm", q_hi, q_lo, k_hi, k_lo)
    if causal:
        l = q.shape[1]
        keep = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -torch.inf)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p_hi, p_lo = split_tf32_plain(p)
    out = three("bhlm,bmhd->blhd", p_hi, p_lo, v_hi, v_lo)
    return out / p.sum(-1).transpose(1, 2).unsqueeze(-1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Attention of fp32 ``q``, ``k``, ``v`` (B, L, H, D) -> (B, L, H, D)
    contiguous, D in {32, 64, 128}; ``causal`` lets query i see keys j <= i.
    Forward only: raises if an input requires grad. Strided views such as
    the per-head split of a fused QKV projection are read in place when the
    three share their strides, (H, D) is contiguous within a token, and the
    rows are 16-byte aligned; anything else is copied first. CPU tensors take
    the plain version; CUDA tensors launch the kernel
    (``flash_attention.launches`` counts the launches)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, l, h, d = q.shape
    in_place = (q.stride() == k.stride() == v.stride() and q.stride(3) == 1 and q.stride(2) == d
                and q.stride(0) % 4 == 0 and q.stride(1) % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    if not in_place:  # the kernel reads rows as float4
        q, k, v = (x.clone(memory_format=torch.contiguous_format) for x in (q, k, v))
    if (l + 64) * q.stride(1) >= 2**31:  # the kernel's offsets inside one (batch, head) are 32-bit
        raise ValueError(f"flash_attention: rows of {q.stride(1)} floats at L={l} exceed the kernel's 32-bit offsets")
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
    if not 0 < l or not 0 < b * h * -(-l // 64) < 2**31:  # the kernel's work items: 64-row query tiles
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
