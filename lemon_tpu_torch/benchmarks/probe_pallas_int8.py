"""int8 against bf16 matrix products on the card (port of
benchmarks/probe_pallas_int8.py).

The question: is the int8 product itself slow, or the unfused quantise
passes around it? The port's int8 modes (``LEMON_TPU_PRECISION=int8`` and
``int8_static``) run their W8A8 projections on ``torch._int_mm`` between
elementwise quantise passes (``models/clip.py``), and are no faster than
bf16 per embedded pair. Every line is a serial chain: each step's input is
the last step's output, int8 steps requantised with
``clamp(y >> 8, -127, 127)`` outside the product (as the JAX probe does
outside Pallas), timed with CUDA events over the chain.

- 4096^3: P4 (``ops/matmul.tiled_matmul``, the hand-written kernel) and the
  library twins, ``torch._int_mm`` and bf16 ``torch.matmul`` (the JAX
  probe's XLA lines).
- The ViT-B MLP pair (12800 x 768 -> 3072 -> 768), int8 with the
  requantisation between, and with an fp32 dequantise + GELU + requantise
  between (the W8A8 layer's epilogue); the qkv + out projections
  (6400 x 768 -> 2304, reshaped, -> 768). On the library twins, and the MLP
  pair and the projections on P4 too.

The weights are constant, so each is transposed once, before any chain:
P4 takes ``w = b^T`` (N, K), the layout of the port's weights, and so does
``torch._int_mm(x, w.t())`` as ``models/clip.int8_matmul`` calls it.

Run on the card: ``python -m lemon_tpu_torch.benchmarks.probe_pallas_int8``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lemon_tpu_torch.benchmarks._timing import chain_ms, device_line, emit, require_cuda
from lemon_tpu_torch.ops.matmul import tiled_matmul

SQUARE = 4096  # M = K = N
MLP = (12800, 768, 3072)  # tokens, width, hidden: ViT-B at the embed pipeline's token count
PROJ = (6400, 768)  # tokens, width


def int8_requant(y32: torch.Tensor) -> torch.Tensor:
    """The quantised layer's epilogue: rescale int32 sums back to int8."""
    return torch.clamp(y32 >> 8, -127, 127).to(torch.int8)


def _int_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch._int_mm(x, w.t())


def _bf16_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.t())


def main(steps: int = 20) -> dict:
    device = require_cuda("probe_pallas_int8")
    print(f"device: {device_line()}", flush=True)
    rng = np.random.default_rng(0)
    results = {}

    def line(name, step, x0, flops):
        ms = chain_ms(step, x0, steps)
        results[name] = {"ms_per_step": ms, "tflops": flops / ms / 1e9}
        print(f"{name:34s} {ms:8.4f} ms/step {flops / ms / 1e9:8.1f} T(FL)OPS", flush=True)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(device)

    def normals(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale).to(device, torch.bfloat16)

    # --- square 4096^3: the library against P4, both type pairs ---------
    m = k = n = SQUARE
    x8, w8 = ints(m, k), ints(n, k)
    xb, wb = normals(m, k), normals(n, k, scale=k**-0.5)
    fl = 2 * m * k * n
    line("library_bf16_square", lambda x: _bf16_mm(x, wb), xb, fl)
    line("library_int8_square", lambda x: int8_requant(_int_mm(x, w8)), x8, fl)
    line("p4_bf16_square", lambda x: tiled_matmul(x, wb), xb, fl)
    line("p4_int8_square", lambda x: int8_requant(tiled_matmul(x, w8)), x8, fl)
    del x8, w8, xb, wb

    # --- ViT-B MLP pair: x (12800, 768) -> 3072 -> 768 --------------------
    m, d, h = MLP
    x8, w1_8, w2_8 = ints(m, d), ints(h, d), ints(d, h)
    xb, w1b, w2b = normals(m, d), normals(h, d, scale=d**-0.5), normals(d, h, scale=h**-0.5)
    fl = 2 * m * d * h * 2
    scale1 = torch.tensor(2e-6, device=device)
    line("library_bf16_mlp", lambda x: _bf16_mm(_bf16_mm(x, w1b), w2b), xb, fl)
    line("library_int8_mlp", lambda x: int8_requant(_int_mm(int8_requant(_int_mm(x, w1_8)), w2_8)), x8, fl)
    line("library_int8_gelu_mlp", lambda x: int8_requant(_int_mm(
        torch.clamp(F.gelu(_int_mm(x, w1_8).float() * scale1) * 127, -127, 127).to(torch.int8), w2_8)), x8, fl)
    line("p4_bf16_mlp", lambda x: tiled_matmul(tiled_matmul(x, w1b), w2b), xb, fl)
    line("p4_int8_mlp", lambda x: int8_requant(tiled_matmul(int8_requant(tiled_matmul(x, w1_8)), w2_8)), x8, fl)
    del x8, w1_8, w2_8, xb, w1b, w2b

    # --- attention projections: 768 -> 2304 (reshaped 3 x 768) -> 768 ----
    m, d = PROJ
    x8, wq8, wo8 = ints(m, d), ints(3 * d, d), ints(d, d)
    xb, wqb, wob = normals(m, d), normals(3 * d, d, scale=d**-0.5), normals(d, d, scale=d**-0.5)
    fl = 2 * m * d * 3 * d + 2 * 3 * m * d * d

    def proj_bf16(mm):
        def step(x):
            q = mm(x, wqb).reshape(3 * x.shape[0], x.shape[1])  # reshape, not slice: nothing to skip
            return mm(q, wob).float().reshape(3, x.shape[0], x.shape[1]).mean(0).to(torch.bfloat16)
        return step

    def proj_int8(mm):
        def step(x):
            q = int8_requant(mm(x, wq8)).reshape(3 * x.shape[0], x.shape[1])
            return int8_requant(mm(q, wo8).reshape(3, x.shape[0], x.shape[1]).sum(0, dtype=torch.int32) >> 2)
        return step

    line("library_bf16_proj", proj_bf16(_bf16_mm), xb, fl)
    line("library_int8_proj", proj_int8(_int_mm), x8, fl)
    line("p4_bf16_proj", proj_bf16(tiled_matmul), xb, fl)
    line("p4_int8_proj", proj_int8(tiled_matmul), x8, fl)
    return emit(results)


if __name__ == "__main__":
    main()
