"""Fused kNN score block + validity mask + 128-column block maxima (K1).

Port of ``lemon_tpu/ops/scoremax.py`` (``fused_scores_blockmax``). The exact
kNN search needs, per (query block, database tile), the fp32 score block
(for the candidate gather) and the maximum of each 128-column strip (the
blockmax prefilter input). The CUDA kernels ``csrc/scoremax.cu`` emit both
in one pass over the score tile: ``high`` (bf16x3) on the tensor cores with
``wgmma``, after a split pass that writes the bf16 hi/lo operands
(:func:`split_bf16`); ``highest`` (exact fp32 products) on the CUDA cores.
Two probe kernels are the same kernels with another output:
:func:`block_maxima` (P3, no store of s) and :func:`scores_blockmax_t` (P2,
the block maxima transposed).

Score semantics follow ``lemon_tpu/knn/index.py:_scores_block``: 'ip' is the
inner product; 'l2' keeps the op order ``-((|q|^2 - 2 ip) + |x|^2)``, the
negated squared distance, so higher is better for both. Columns whose global
index ``start + j`` is at or past ``n_valid`` come out as ``-inf``: the port
gathers candidates with plain indexing, so it needs no finite sentinel
(the JAX package's ``MASKED`` existed for its one-hot matmul gather).
"""

from __future__ import annotations

import torch

from lemon_tpu_torch.ops import _build

LANES = 128
SPLIT_ALIGN = 64  # the split operands' D is padded to whole 128-byte rows of bf16
PRECISIONS = ("highest", "high")


def padded_depth(d: int) -> int:
    return -(-d // SPLIT_ALIGN) * SPLIT_ALIGN


def split_bf16_plain(x: torch.Tensor):
    """Plain version of :func:`split_bf16`: ``hi = bf16(x)``,
    ``lo = bf16(x - hi)`` (round to nearest even), as bf16 (N, Dp) with D
    zero-padded to :func:`padded_depth`."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    pad = padded_depth(x.shape[1]) - x.shape[1]
    return torch.nn.functional.pad(hi, (0, pad)), torch.nn.functional.pad(lo, (0, pad))


def split_bf16(x: torch.Tensor):
    """The bf16x3 operands of ``x`` (N, D) contiguous float32: (hi, lo), each
    (N, Dp) bf16, K-major, D zero-padded to a multiple of 64. CPU tensors
    take the plain version; CUDA tensors run the split pass of K1."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"split_bf16: need a contiguous 2-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return split_bf16_plain(x)
    n, d = x.shape
    dp = padded_depth(d)
    hi = torch.empty((n, dp), dtype=torch.bfloat16, device=x.device)
    lo = torch.empty((n, dp), dtype=torch.bfloat16, device=x.device)
    code = _build.library().lemon_split_bf16(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), n, d, dp,
                                             _build.stream_handle(x))
    _build.check(code, "split_bf16")
    return hi, lo


def _inner_products(q: torch.Tensor, db: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "high":
        # lemon_tpu/ops/scoremax.py:59-64: three bf16 products, fp32 sums
        q_hi, q_lo = (t.float() for t in split_bf16_plain(q))
        db_hi, db_lo = (t.float() for t in split_bf16_plain(db))
        return q_hi @ db_hi.T + (q_hi @ db_lo.T + q_lo @ db_hi.T)
    return q @ db.T


def scores_blockmax_plain(q, db, metric="ip", db_sqnorm=None, start=0, n_valid=None, precision="highest"):
    """Plain PyTorch version of :func:`scores_blockmax` (any device)."""
    _check(q, db, metric, db_sqnorm, precision)
    b, t = q.shape[0], db.shape[0]
    n_valid = t + start if n_valid is None else n_valid
    s = _inner_products(q, db, precision)
    if metric == "l2":
        s = -(((q * q).sum(1, keepdim=True) - 2.0 * s) + db_sqnorm[None, :])
    col = start + torch.arange(t, device=q.device)
    s = torch.where(col[None, :] < n_valid, s, torch.full((), -torch.inf, device=q.device))
    return s, s.view(b, t // LANES, LANES).amax(dim=2)


def scores_blockmax(q, db, metric="ip", db_sqnorm=None, start=0, n_valid=None, precision="highest"):
    """(scores (B, T), block maxima (B, T/128)) of ``q`` (B, D) against the
    database tile ``db`` (T, D), both fp32 and contiguous, T a multiple of
    128. ``db_sqnorm`` (T,) is required for 'l2'. ``n_valid=None`` masks
    nothing. CPU tensors take the plain version; CUDA tensors launch the
    kernel (``scores_blockmax.launches`` counts the launches of both
    precisions, ``scores_blockmax.launches_highest`` those of ``highest``)."""
    _check(q, db, metric, db_sqnorm, precision)
    if q.device.type == "cpu":
        return scores_blockmax_plain(q, db, metric, db_sqnorm, start, n_valid, precision)
    s, bmax = _launch("scores_blockmax", q, db, metric, db_sqnorm, start, n_valid, precision, _OUT_K1)
    scores_blockmax.launches += 1
    scores_blockmax.launches_highest += precision == "highest"
    return s, bmax


scores_blockmax.launches = 0
scores_blockmax.launches_highest = 0


def block_maxima_plain(q, db, precision="highest"):
    """Plain PyTorch version of :func:`block_maxima` (any device)."""
    return scores_blockmax_plain(q, db, "ip", None, 0, None, precision)[1]


def block_maxima(q, db, precision="highest"):
    """The (B, T/128) block maxima of ``q . db^T`` alone (P3: no mask, no
    score block stored), for ``q`` (B, D) and ``db`` (T, D) as in
    :func:`scores_blockmax` ('ip'). Port of ``bmax_only``
    (benchmarks/probe_knn_decomp.py:95): against K1 it prices K1's store
    of s. CPU tensors take the plain version; CUDA tensors launch K1's
    kernel without its store (``block_maxima.launches``)."""
    _check(q, db, "ip", None, precision)
    if q.device.type == "cpu":
        return block_maxima_plain(q, db, precision)
    _, bmax = _launch("block_maxima", q, db, "ip", None, 0, None, precision, _OUT_MAX_ONLY)
    block_maxima.launches += 1
    return bmax


block_maxima.launches = 0


def scores_blockmax_t_plain(q, db, start=0, n_valid=None, precision="highest"):
    """Plain PyTorch version of :func:`scores_blockmax_t` (any device)."""
    s, bmax = scores_blockmax_plain(q, db, "ip", None, start, n_valid, precision)
    return s, bmax.T.contiguous()


def scores_blockmax_t(q, db, start=0, n_valid=None, precision="highest"):
    """K1 ('ip') with the block maxima written transposed (P2): (scores
    (B, T), block maxima (T/128, B)). Port of ``fused_t``
    (benchmarks/probe_scoremax2.py:61); masked columns are ``-inf`` as in
    K1 (JAX writes ``MASKED``). CPU tensors take the plain version; CUDA
    tensors launch K1's kernel with the transposed maxima
    (``scores_blockmax_t.launches``)."""
    _check(q, db, "ip", None, precision)
    if q.device.type == "cpu":
        return scores_blockmax_t_plain(q, db, start, n_valid, precision)
    s, bmax_t = _launch("scores_blockmax_t", q, db, "ip", None, start, n_valid, precision, _OUT_TRANSPOSED)
    scores_blockmax_t.launches += 1
    return s, bmax_t


scores_blockmax_t.launches = 0

# what the kernels write (csrc/scoremax.cu, `Out`)
_OUT_K1, _OUT_MAX_ONLY, _OUT_TRANSPOSED = 0, 1, 2


def _launch(name, q, db, metric, db_sqnorm, start, n_valid, precision, out):
    """One launch of K1's kernels writing ``out``: (s, bmax), s None for P3."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, d = q.shape
    t = db.shape[0]
    if b > 65535 * 64:
        raise ValueError(f"{name}: {b} query rows exceed the launch grid")
    s = None if out == _OUT_MAX_ONLY else torch.empty((b, t), dtype=torch.float32, device=q.device)
    shape = (t // LANES, b) if out == _OUT_TRANSPOSED else (b, t // LANES)
    bmax = torch.empty(shape, dtype=torch.float32, device=q.device)
    n_valid = t + start if n_valid is None else n_valid
    qsq = (q * q).sum(1) if metric == "l2" else None
    norms = (None if qsq is None else qsq.data_ptr(), None if db_sqnorm is None else db_sqnorm.data_ptr())
    tail = (None if s is None else s.data_ptr(), bmax.data_ptr(), b, t)
    lib = _build.library()
    if precision == "high":
        (q_hi, q_lo), (db_hi, db_lo) = split_bf16(q), split_bf16(db)
        code = lib.lemon_scores_blockmax_high(
            q_hi.data_ptr(), q_lo.data_ptr(), db_hi.data_ptr(), db_lo.data_ptr(), *norms, *tail,
            q_hi.shape[1], int(start), int(n_valid), int(metric == "l2"), out, _build.stream_handle(q),
        )
    else:
        code = lib.lemon_scores_blockmax_highest(
            q.data_ptr(), db.data_ptr(), *norms, *tail, d, int(start), int(n_valid), int(metric == "l2"), out,
            _build.stream_handle(q),
        )
    _build.check(code, name)
    return s, bmax


def _check(q, db, metric, db_sqnorm, precision) -> None:
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be 'ip' or 'l2', got {metric!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"scores_blockmax: shapes {tuple(q.shape)} x {tuple(db.shape)}")
    if q.shape[0] == 0 or db.shape[0] == 0 or db.shape[0] % LANES:
        raise ValueError(f"scores_blockmax: need B > 0 and T a positive multiple of {LANES}, got {tuple(db.shape)}")
    tensors = [q, db] + ([db_sqnorm] if metric == "l2" else [])
    if metric == "l2" and (db_sqnorm is None or tuple(db_sqnorm.shape) != (db.shape[0],)):
        raise ValueError("scores_blockmax: 'l2' needs db_sqnorm of shape (T,)")
    for x in tensors:
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != q.device:
            raise ValueError("scores_blockmax: inputs must be contiguous float32 on one device")
