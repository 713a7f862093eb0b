"""Variants of the kNN select stage (port of benchmarks/probe_knn_select3.py):
q 8192 against one 131072-row tile, k = 51, the score block and its block
maxima from K1 at 'high'. Each variant maps (s, bmax) to the top-k values
and global ids, with -inf slots pinned to id 131072 (n_valid):

- A_baseline : the port's search tail, ``knn/index._blockmax_select``: K2
               over the block maxima, a plain gather of the k candidate
               blocks, K2 over the candidates, ids rebuilt from (block, lane)
- B_colids   : P1 (``ops/select.topk_colids``): the candidates' global ids
               built by broadcast-add from the sorted block ids, and the
               top-k reading them, so nothing is rebuilt
- K4_fused   : K4 (``ops/select.fused_gather_topk``): gather and top-k in
               one kernel, the port's fused reference

The JAX probe's other variants ask questions of XLA that eager PyTorch does
not have, so they are not timed again: E (the pair-folded top-k) computes
B's function, and on the card one kernel serves both; C (``take_along`` in
place of the one-hot gather) is B, whose gather is already a plain gather;
D (B as two programs) is B, since every eager call is its own dispatch.

Every variant is checked against A, values and ids exact, before timing.
Timed with CUDA events, reported per query row.

Run on the card: ``python -m lemon_tpu_torch.benchmarks.probe_knn_select3``.
"""

from __future__ import annotations

import numpy as np
import torch

from lemon_tpu_torch.benchmarks._timing import cuda_ms, device_line, emit, require_cuda
from lemon_tpu_torch.knn.index import _blockmax_select
from lemon_tpu_torch.ops.scoremax import LANES, scores_blockmax
from lemon_tpu_torch.ops.select import fused_gather_topk, topk_colids
from lemon_tpu_torch.ops.topk import topk

N_DB, D, K = 131_072, 512, 51
N_Q = 8192
W = K * LANES


def _pin(vals: torch.Tensor, idx: torch.Tensor):
    """-inf slots have no database row behind them: id n_valid."""
    return vals, torch.where(torch.isneginf(vals), torch.full_like(idx, N_DB), idx)


def candidates(sb: torch.Tensor, block_ids: torch.Tensor):
    """The (B, k*128) candidates of the sorted blocks and their global ids."""
    b = sb.shape[0]
    cand = sb.gather(1, block_ids[:, :, None].expand(b, K, LANES)).reshape(b, W)
    lane = torch.arange(LANES, device=sb.device, dtype=torch.int32)
    cid = (block_ids.to(torch.int32)[:, :, None] * LANES + lane).reshape(b, W)
    return cand, cid


def select_a(s, bmax):
    return _pin(*_blockmax_select(s, bmax, K))


def select_b(s, bmax):
    block_ids = topk(bmax, K)[1].sort(dim=1).values
    vals, ids = topk_colids(*candidates(s.view(s.shape[0], -1, LANES), block_ids), K)
    return _pin(vals, ids.long())


def select_k4(s, bmax):
    block_ids = topk(bmax, K)[1].sort(dim=1).values
    return _pin(*fused_gather_topk(s.view(s.shape[0], -1, LANES), block_ids, K))


VARIANTS = {"A_baseline": select_a, "B_colids": select_b, "K4_fused": select_k4}


def main(iters: int = 10) -> dict:
    device = require_cuda("probe_knn_select3")
    print(f"device: {device_line()}", flush=True)
    rng = np.random.default_rng(1)
    xb = rng.standard_normal((N_DB, D)).astype(np.float32)
    xq = rng.standard_normal((N_Q, D)).astype(np.float32)
    xb = torch.from_numpy(xb / np.linalg.norm(xb, axis=1, keepdims=True)).to(device)
    xq = torch.from_numpy(xq / np.linalg.norm(xq, axis=1, keepdims=True)).to(device)
    s, bmax = scores_blockmax(xq, xb, "ip", None, 0, N_DB, "high")
    del xb, xq

    ref_v, ref_i = select_a(s, bmax)
    for name, fn in VARIANTS.items():
        v, i = fn(s, bmax)
        torch.cuda.synchronize()
        if not (torch.equal(v, ref_v) and torch.equal(i, ref_i)):
            raise RuntimeError(f"probe_knn_select3: {name} differs from A_baseline")
    print(f"correctness: {', '.join(VARIANTS)} all match A_baseline", flush=True)

    results = {}
    for name, fn in VARIANTS.items():
        us = cuda_ms(lambda: fn(s, bmax), iters) * 1e3 / N_Q
        results[f"{name}_us_row"] = us
        print(f"{name:12s}: {us:6.3f} us/row", flush=True)
    return emit(results)


if __name__ == "__main__":
    main()
