"""K1 against P2, its variant with the block maxima written transposed (port
of benchmarks/probe_scoremax2.py).

On the TPU the transposed (T/128, B) layout dodged Mosaic's lane-store rule
(the row strip had to be merged with a chain of selects). The port's K1
writes each 128-column strip's maximum straight to its place, so on the
card P2 (``ops/scoremax.scores_blockmax_t``) only asks which layout suits
the consumer: the block top-k reads (B, T/128), so the transposed kernel's
output costs one transpose, which the ``transposed + .T`` line includes.

B 4096 queries against T 65536 columns, D 512, at both precisions; the
block maxima of the two layouts are checked against each other before
timing (1e-5, the JAX probe's assert; the port's two are bit-equal, as they
share one summation order). Timed with CUDA events, reported per query row.

Run on the card: ``python -m lemon_tpu_torch.benchmarks.probe_scoremax2``.
"""

from __future__ import annotations

import numpy as np
import torch

from lemon_tpu_torch.benchmarks._timing import cuda_ms, device_line, emit, require_cuda
from lemon_tpu_torch.ops.scoremax import scores_blockmax, scores_blockmax_t

# B kept small: the (B, T) fp32 score block is 1 GB at 4096 rows
B, T, D = 4096, 65536, 512


def main(iters: int = 5) -> dict:
    device = require_cuda("probe_scoremax2")
    print(f"device: {device_line()}", flush=True)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(device)
    db = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)).to(device)
    results = {}
    for prec in ("highest", "high"):
        def prod():
            return scores_blockmax(q, db, "ip", None, 0, T, prec)

        def trans():
            s, bt = scores_blockmax_t(q, db, 0, T, prec)
            return s, bt.T.contiguous()  # the consumer's layout

        def trans_raw():
            return scores_blockmax_t(q, db, 0, T, prec)

        (s0, b0), (s1, b1) = prod(), trans()
        torch.cuda.synchronize()
        if not torch.allclose(b0, b1, rtol=0, atol=1e-5):
            raise RuntimeError(f"probe_scoremax2 {prec}: block maxima of the two layouts differ")
        del s0, b0, s1, b1
        scale = 1e3 / B  # ms per call -> us per row
        per = {name: cuda_ms(fn, iters) * scale for name, fn in
               (("production", prod), ("transposed_T", trans), ("transposed_raw", trans_raw))}
        results.update({f"{prec}_{name}_us_row": us for name, us in per.items()})
        print(f"[{prec}] production (row-major block maxima): {per['production']:.3f} us/row | transposed + .T: "
              f"{per['transposed_T']:.3f} | transposed raw: {per['transposed_raw']:.3f}", flush=True)
    return emit(results)


if __name__ == "__main__":
    main()
