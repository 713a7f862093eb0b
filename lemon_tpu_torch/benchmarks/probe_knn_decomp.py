"""Per-stage decomposition of the port's exact kNN search (port of
benchmarks/probe_knn_decomp.py): q 8192 against a single 131072 x 512 tile,
k = 51, at ``high`` and ``highest``. Each stage is timed with CUDA events
at 8192 query rows and reported per query row:

- full           : the search of one query chunk (``knn/index._search_chunk``
                   over one tile: K1, then the block-max select)
- kernel         : K1 (``scores_blockmax``): the score block, the mask, the
                   block maxima and the (B, T) store of s
- kernel_nostore : P3 (``block_maxima``): the block maxima alone, no store;
                   ``kernel - kernel_nostore`` prices the store of s
                   (524 KB a query row at 131072 columns), the ceiling of any
                   design that selects inside the kernel
- bmax_topk      : K2 over the (B, 1024) block maxima, and the sort of the ids
- gather         : the candidate gather out of the stored score block (a
                   plain ``torch.gather``; the JAX probe's one-hot matmul at
                   'high' was a TPU workaround)
- final_topk     : K2 over the (B, k*128) candidates
- select         : ``knn/index._blockmax_select`` end to end

Sanity: kernel + select + glue ~= full.

Run on the card: ``python -m lemon_tpu_torch.benchmarks.probe_knn_decomp``.
"""

from __future__ import annotations

import numpy as np
import torch

from lemon_tpu_torch.benchmarks._timing import cuda_ms, device_line, emit, require_cuda
from lemon_tpu_torch.knn.index import _blockmax_select, _search_chunk
from lemon_tpu_torch.ops.scoremax import LANES, block_maxima, scores_blockmax
from lemon_tpu_torch.ops.topk import topk

N_DB, D, K = 131_072, 512, 51
N_Q = 8192


def unit_rows(rng, n: int, d: int, device) -> torch.Tensor:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(device)


def main(iters: int = 3) -> dict:
    device = require_cuda("probe_knn_decomp")
    print(f"device: {device_line()}", flush=True)
    rng = np.random.default_rng(1)
    xb = unit_rows(rng, N_DB, D, device)
    q = unit_rows(rng, N_Q, D, device)
    results = {}
    for precision in ("high", "highest"):
        per_row = {}

        def record(name, fn):
            us = cuda_ms(fn, iters) * 1e3 / N_Q
            per_row[name] = us
            results[f"{precision}_{name}_us_row"] = us
            print(f"[{precision}] {name:16s}: {us:7.3f} us/row ({N_DB / us / 1e3:.2f} B pairs/s)",
                  flush=True)

        record("full", lambda: _search_chunk(q, xb, None, K, "ip", N_DB, N_DB, precision))
        record("kernel", lambda: scores_blockmax(q, xb, "ip", None, 0, N_DB, precision))
        record("kernel_nostore", lambda: block_maxima(q, xb, precision))

        s, bmax = scores_blockmax(q, xb, "ip", None, 0, N_DB, precision)
        block_ids = topk(bmax, K)[1].sort(dim=1).values
        sb = s.view(N_Q, N_DB // LANES, LANES)
        idx = block_ids[:, :, None].expand(N_Q, K, LANES)
        cand = sb.gather(1, idx).reshape(N_Q, K * LANES)
        record("bmax_topk", lambda: topk(bmax, K)[1].sort(dim=1))
        record("gather", lambda: sb.gather(1, idx))
        record("final_topk", lambda: topk(cand, K))
        record("select", lambda: _blockmax_select(s, bmax, K))
        del s, bmax, sb, cand

        store = per_row["kernel"] - per_row["kernel_nostore"]
        glue = per_row["full"] - per_row["kernel"] - per_row["select"]
        results[f"{precision}_score_store_us_row"] = store
        results[f"{precision}_glue_us_row"] = glue
        print(f"[{precision}] score-block store: {store:.3f} us/row; full - kernel - select (glue): {glue:.3f} us/row",
              flush=True)
    return emit(results)


if __name__ == "__main__":
    main()
