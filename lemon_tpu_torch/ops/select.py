"""Fused candidate gather + top-k over global column ids (K4).

Port of ``lemon_tpu/ops/select.py`` (``fused_gather_topk``): given the
block-major scores of a database tile and, per row, the k 128-column blocks
that hold its top-k (sorted ascending), one kernel gathers the k*128
candidates and selects the top k with the FAISS tie rule, returning global
column ids. The CUDA kernel is ``csrc/select.cu``.

Like the JAX function, it is not wired into the search: ``ExactKnnIndex``
runs the unfused tail :func:`gather_then_topk` with K2. Unlike the JAX
function, masked columns arrive and leave as ``-inf``: the port's K1 writes
``-inf`` and a CUDA gather has no ``0 * -inf`` hazard, so there is no finite
``MASKED`` sentinel.

P1, :func:`topk_colids`, is the row top-k of candidates that arrive with a
global column id each (``topk_colids``/``topk_pair`` of
``benchmarks/probe_knn_select3.py``): K2's kernel (``csrc/topk.cu``) reads
the id of each chosen entry, so no index is reconstructed. K4 and P1 run
K2's selects (``csrc/select_rows.cuh``): K4 at k <= 8 the warp select, one
warp a row over its k gathered blocks, above that the block select; P1 the
variant K2's ``auto`` picks.
"""

from __future__ import annotations

import torch

from lemon_tpu_torch.ops import _build
from lemon_tpu_torch.ops.scoremax import LANES
from lemon_tpu_torch.ops.topk import topk_plain

MAX_K = 128


def gather_then_topk(sb: torch.Tensor, block_ids: torch.Tensor, k: int, topk_fn):
    """The unfused select: gather the candidate blocks, ``topk_fn`` over
    them, then global ids from (slot, lane). Sorted block ids put the
    candidates in ascending column order, so ``topk_fn``'s lower-column
    tie rule is the global one."""
    b = sb.shape[0]
    cand = sb.gather(1, block_ids[:, :, None].expand(b, k, LANES)).reshape(b, k * LANES)
    vals, pos = topk_fn(cand, k)
    return vals, block_ids.gather(1, pos // LANES) * LANES + pos % LANES


def fused_gather_topk_plain(sb: torch.Tensor, block_ids: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`fused_gather_topk` (any device)."""
    _check(sb, block_ids, k)
    return gather_then_topk(sb, block_ids, k, topk_plain)


def fused_gather_topk(sb: torch.Tensor, block_ids: torch.Tensor, k: int):
    """(values (B, k) float32, global column ids (B, k) int64) of the top k
    entries among the blocks ``block_ids`` (B, k) int64 of ``sb``
    (B, n_blocks, 128) contiguous float32; each row's block ids sorted
    ascending and distinct, ``0 < k <= min(n_blocks, 128)``. Values descend,
    ties go to the lower global column, ``-inf`` entries come last in column
    order. CPU tensors take the plain version; CUDA tensors launch the kernel
    (``fused_gather_topk.launches`` counts the launches)."""
    _check(sb, block_ids, k)
    if sb.device.type == "cpu":
        return fused_gather_topk_plain(sb, block_ids, k)
    if sb.device.type != "cuda":
        raise ValueError(f"fused_gather_topk: unsupported device {sb.device}")
    b, nb, _ = sb.shape
    vals = torch.empty((b, k), dtype=torch.float32, device=sb.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=sb.device)
    code = _build.library().lemon_gather_topk(
        sb.data_ptr(), block_ids.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, nb, k, _build.stream_handle(sb)
    )
    _build.check(code, "fused_gather_topk")
    fused_gather_topk.launches += 1
    return vals, idx


fused_gather_topk.launches = 0


GATHER_LOADS = {-2: "warp 16-byte", -1: "warp scalar", 0: "bulk", 1: "staged"}


def gather_load(sb: torch.Tensor, k: int) -> str:
    """How the kernel loads the gathered rows of ``sb`` (on the card) at
    this k, as ``csrc/select.cu`` picks it: the warp path (k <= 8) into
    registers, ``"warp 16-byte"`` or ``"warp scalar"`` (sb not 16-byte
    aligned); else staged in shared memory, ``"bulk"`` (k bulk copies of 512
    bytes) or ``"staged"`` (plain loads)."""
    return GATHER_LOADS[_build.library().lemon_gather_topk_load(sb.data_ptr(), k)]


def warp_slots(k: int) -> int:
    """Block slots of the warp path's instance at k <= 8 (4 registers a lane
    each), as ``csrc/select.cu`` picks it: 2, 4, 6 or 8."""
    return 2 * -(-k // 2)


def _check(sb: torch.Tensor, block_ids: torch.Tensor, k: int) -> None:
    if sb.dim() != 3 or sb.shape[2] != LANES or sb.dtype != torch.float32 or not sb.is_contiguous():
        raise ValueError(f"fused_gather_topk: need contiguous float32 (B, n_blocks, {LANES}), got {sb.dtype} {tuple(sb.shape)}")
    b, nb, _ = sb.shape
    if not 0 < k <= min(nb, MAX_K):
        raise ValueError(f"fused_gather_topk: need 0 < k <= min(n_blocks={nb}, {MAX_K}), got k={k}")
    if block_ids.shape != (b, k) or block_ids.dtype != torch.int64 or not block_ids.is_contiguous():
        raise ValueError(f"fused_gather_topk: need contiguous int64 block_ids of shape {(b, k)}, got {block_ids.dtype} {tuple(block_ids.shape)}")
    if block_ids.device != sb.device:
        raise ValueError("fused_gather_topk: sb and block_ids must be on one device")
    if not 0 < b < 2**31 or nb * LANES >= 2**31:
        raise ValueError(f"fused_gather_topk: unsupported shape {tuple(sb.shape)}")


def topk_colids_plain(x: torch.Tensor, cid: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`topk_colids` (any device)."""
    _check_colids(x, cid, k)
    vals, pos = topk_plain(x, k)
    return vals, cid.gather(1, pos)


def topk_colids(x: torch.Tensor, cid: torch.Tensor, k: int):
    """(values (B, k) float32, ids (B, k) int32) of the k largest entries of
    each row of ``x`` (B, W) contiguous float32, where ``cid`` (B, W)
    contiguous int32 is each entry's global id, ascending along each row
    (sorted block ids x 128 + lane). Values descend, ties go to the lowest
    id, and ``-inf`` entries come out as ``-inf`` with the lowest remaining
    ids, as in ``topk_colids`` and ``topk_pair`` of
    benchmarks/probe_knn_select3.py (:89, :163). CPU tensors take the plain
    version; CUDA tensors launch K2's kernel, its variant picked by (W, k),
    with the id read (``topk_colids.launches``)."""
    _check_colids(x, cid, k)
    if x.device.type == "cpu":
        return topk_colids_plain(x, cid, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk_colids: unsupported device {x.device}")
    b, w = x.shape
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=x.device)
    code = _build.library().lemon_topk_colids(
        x.data_ptr(), cid.data_ptr(), vals.data_ptr(), ids.data_ptr(), b, w, k, _build.stream_handle(x)
    )
    _build.check(code, "topk_colids")
    topk_colids.launches += 1
    return vals, ids


topk_colids.launches = 0


def _check_colids(x: torch.Tensor, cid: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"topk_colids: need a contiguous 2-D float32 x, got {x.dtype} {tuple(x.shape)}")
    if cid.shape != x.shape or cid.dtype != torch.int32 or not cid.is_contiguous() or cid.device != x.device:
        raise ValueError(f"topk_colids: need a contiguous int32 cid of shape {tuple(x.shape)} on x's device, "
                         f"got {cid.dtype} {tuple(cid.shape)}")
    b, w = x.shape
    if not 0 < k <= w or not 0 < b < 2**31:
        raise ValueError(f"topk_colids: need 0 < k <= W={w} and B > 0, got k={k}, B={b}")
