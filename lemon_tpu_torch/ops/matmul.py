"""Tiled matrix product on the tensor cores (P4).

Port of ``pallas_matmul`` (benchmarks/probe_pallas_int8.py:53), the probe
that asks whether a hand-written int8 product beats the library's. The CUDA
kernel is ``csrc/matmul.cu``: ``a @ w^T`` for ``a`` (M, K) and ``w`` (N, K),
int8 x int8 -> int32 or bf16 x bf16 -> bf16 (fp32 sums rounded once).

``w`` is the second operand transposed, (N, K) with K contiguous: the
layout of a ``torch.nn.Linear`` weight and of the port's int8 weights
(``models/clip.int8_matmul``), and the only one the integer ``wgmma`` takes
(K-major). A caller with the probe's (K, N) ``b`` passes
``b.t().contiguous()`` once.
"""

from __future__ import annotations

import torch

from lemon_tpu_torch.ops import _build

TILE = 128  # M and N are multiples of the kernel's 128 x 128 output tile
K_ALIGN = 64
DTYPES = {torch.int8: torch.int32, torch.bfloat16: torch.bfloat16}


def tiled_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`tiled_matmul` (any device). int8:
    the products summed in float64, exact while the sums stay below 2^53
    (the kernel's int32 sums are exact below 2^31). bf16: an fp32 product
    rounded once to bf16."""
    _check(a, w)
    if a.dtype == torch.int8:
        return (a.double() @ w.double().T).to(torch.int32)
    return (a.float() @ w.float().T).to(torch.bfloat16)


def tiled_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w^T`` for ``a`` (M, K) and ``w`` (N, K), contiguous, both int8
    (-> int32) or both bf16 (-> bf16, fp32 sums); M and N multiples of 128,
    K a multiple of 64. CPU tensors take the plain version; CUDA tensors
    launch the kernel (``tiled_matmul.launches`` counts the launches,
    ``tiled_matmul.launches_int8`` those of the int8 type pair)."""
    _check(a, w)
    if a.device.type == "cpu":
        return tiled_matmul_plain(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {a.device}")
    (m, k), n = a.shape, w.shape[0]
    c = torch.empty((m, n), dtype=DTYPES[a.dtype], device=a.device)
    lib = _build.library()
    fn = lib.lemon_matmul_int8 if a.dtype == torch.int8 else lib.lemon_matmul_bf16
    code = fn(a.data_ptr(), w.data_ptr(), c.data_ptr(), m, n, k, _build.stream_handle(a))
    _build.check(code, "tiled_matmul")
    tiled_matmul.launches += 1
    tiled_matmul.launches_int8 += int(a.dtype == torch.int8)
    return c


tiled_matmul.launches = 0
tiled_matmul.launches_int8 = 0


def _check(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"tiled_matmul: need a (M, K) and w (N, K), got {tuple(a.shape)} and {tuple(w.shape)}")
    if a.dtype not in DTYPES or w.dtype != a.dtype:
        raise ValueError(f"tiled_matmul: need both int8 or both bf16, got {a.dtype} and {w.dtype}")
    if not a.is_contiguous() or not w.is_contiguous() or a.device != w.device:
        raise ValueError("tiled_matmul: inputs must be contiguous and on one device")
    (m, k), n = a.shape, w.shape[0]
    if m == 0 or n == 0 or k == 0 or m % TILE or n % TILE or k % K_ALIGN or m // TILE > 65535:
        raise ValueError(f"tiled_matmul: need M, N positive multiples of {TILE} (M <= {65535 * TILE}) and K a "
                         f"positive multiple of {K_ALIGN}, got M={m}, N={n}, K={k}")
