"""Flash attention over the CLIP towers' (B, L, H, D) layout (K3).

Port of ``lemon_tpu/ops/attention.py`` (``flash_attention``). One kernel
computes ``q @ k^T`` scaled by ``D**-0.5``, the optionally causal online
softmax and the ``@ v`` contraction without writing the (L, L) logits to
device memory; running max, normaliser and accumulator stay in fp32, and the
output has the inputs' dtype, as the TPU kernel writes q's dtype. The CUDA
kernels are in ``csrc/attention.cu``, forward only like the TPU kernel (the
encoder is frozen), for head dims 32, 64 and 128:

- fp32 inputs: both products in 3xTF32 on the tensor cores (``hi.hi + hi.lo
  + lo.hi`` of TF32 splits, accumulated in fp32), q, k and v loaded by TMA
  into an mbarrier ring and split in shared memory;
- bf16 inputs (the towers' bf16 and int8 modes): ``S = q . k^T`` as one bf16
  product (exact products, fp32 sums), scaled in fp32, and ``P . v`` as
  ``p_hi . v + p_lo . v`` with P split into two bf16 values; the fp32
  result is rounded to bf16 once.

:func:`flash_attention_plain` is the counterpart of the JAX package's
``reference_attention`` (for bf16 inputs: upcast, fp32 attention, round) and
the kernels' yardstick; :func:`flash_attention_3xtf32_plain` and
:func:`flash_attention_bf16_plain` repeat each kernel's precision scheme in
plain fp32 arithmetic. The CPU tests and ``chip_smoke.py`` use them, nothing
on the card's path does.
"""

from __future__ import annotations

import torch

from lemon_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _causal_fill(logits: torch.Tensor, causal: bool) -> torch.Tensor:
    if not causal:
        return logits
    l = logits.shape[-1]
    keep = torch.ones(l, l, dtype=torch.bool, device=logits.device).tril()
    return logits.masked_fill(~keep, -torch.inf)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` (any device): fp32
    attention of the inputs upcast to fp32, returned in their dtype."""
    _check(q, k, v)
    dtype = q.dtype
    q, k, v = (x.float() for x in (q, k, v))
    d = q.shape[-1]
    logits = _causal_fill(torch.einsum("blhd,bmhd->bhlm", q * d ** -0.5, k), causal)
    return torch.einsum("bhlm,bmhd->blhd", torch.softmax(logits, dim=-1), v).to(dtype)


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

    logits = _causal_fill(three("blhd,bmhd->bhlm", q_hi, q_lo, k_hi, k_lo), causal)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p_hi, p_lo = split_tf32_plain(p)
    out = three("bhlm,bmhd->blhd", p_hi, p_lo, v_hi, v_lo)
    return out / p.sum(-1).transpose(1, 2).unsqueeze(-1)


def flash_attention_bf16_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """:func:`flash_attention_plain` of bf16 inputs with the bf16 kernel's
    scheme: ``S = q . k^T`` of the bf16 values in fp32 (every product of two
    bf16 values is exact in fp32), scaled by ``D**-0.5`` in fp32, the
    unnormalised probabilities P split into bf16 ``p_hi + p_lo``, and
    ``(p_hi . v + p_lo . v) / sum(P)`` in fp32, rounded to bf16 once. It
    differs from the kernel only in the order of the sums and in an fp32
    rounding of the exponent (the kernel scales inside it, as
    ``2^(s * scale * log2 e - m * scale * log2 e)``)."""
    _check(q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bf16_plain: needs bf16 inputs, got {q.dtype}")
    q, k, v = (x.float() for x in (q, k, v))
    d = q.shape[-1]
    logits = _causal_fill(torch.einsum("blhd,bmhd->bhlm", q, k) * d ** -0.5, causal)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    out = torch.einsum("bhlm,bmhd->blhd", p_hi, v) + torch.einsum("bhlm,bmhd->blhd", p_lo, v)
    return (out / p.sum(-1).transpose(1, 2).unsqueeze(-1)).bfloat16()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Attention of fp32 or bf16 ``q``, ``k``, ``v`` (B, L, H, D) -> (B, L, H,
    D) contiguous in the inputs' dtype, D in {32, 64, 128}; ``causal`` lets
    query i see keys j <= i. Forward only: raises if an input requires grad.
    Strided views such as the per-head split of a fused QKV projection are
    read in place when the three share their strides, (H, D) is contiguous
    within a token, and the rows are 16-byte aligned; anything else is copied
    first. CPU tensors take the plain version; CUDA tensors launch the kernel
    of their dtype (``flash_attention.launches`` counts the launches of both,
    ``flash_attention.launches_bf16`` those of the bf16 kernel)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, l, h, d = q.shape
    per16 = 16 // q.element_size()  # elements in the 16 bytes the kernels read at once
    in_place = (q.stride() == k.stride() == v.stride() and q.stride(3) == 1 and q.stride(2) == d
                and q.stride(0) % per16 == 0 and q.stride(1) % per16 == 0
                and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    if not in_place:
        q, k, v = (x.clone(memory_format=torch.contiguous_format) for x in (q, k, v))
    if (l + 64) * q.stride(1) >= 2**31:  # the kernels' offsets inside one (batch, head) are 32-bit
        raise ValueError(f"flash_attention: rows of {q.stride(1)} elements at L={l} exceed the kernel's 32-bit offsets")
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    launch = _build.library().lemon_flash_attention_bf16 if bf16 else _build.library().lemon_flash_attention
    code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, h, d,
                  q.stride(0), q.stride(1), d ** -0.5, int(causal), _build.stream_handle(q))
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_bf16 += bf16
    return out


flash_attention.launches = 0
flash_attention.launches_bf16 = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if any(x.requires_grad for x in (q, k, v)):
        raise ValueError("flash_attention: forward only (the kernel has no backward); got an input that requires grad")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: need q, k, v of one (B, L, H, D) shape, got {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in DTYPES or any(x.dtype != q.dtype or x.device != q.device for x in (q, k, v)):
        raise ValueError(f"flash_attention: inputs must be all float32 or all bfloat16 on one device, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, l, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if not 0 < l or not 0 < b * h * -(-l // 64) < 2**31:  # the kernel's work items: 64-row query tiles
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
