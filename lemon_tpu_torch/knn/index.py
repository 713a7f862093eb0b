"""Exact k-nearest-neighbour search with FAISS semantics
(port of lemon_tpu/knn/index.py, single device).

Contracts (the reference's FAISS ``IndexFlatIP``/``IndexFlatL2``,
run_lemon.py:166-177,235-236):

- metric 'ip' returns inner products in descending order; 'l2' returns
  squared euclidean distances in ascending order;
- ties go to the lower database index;
- a slot with no database row behind it (k > ntotal) returns ``-inf``
  ('ip'; ``+inf`` for 'l2') with index ``ntotal``.

Execution: queries go in chunks of ``search_q_chunk()`` rows; the database
goes in tiles of ``auto_tile`` rows (a multiple of 128). For every tile the
score block and its 128-column block maxima come from kernel K1
(:func:`lemon_tpu_torch.ops.scoremax.scores_blockmax`); the top-k comes from
kernel K2 (:func:`lemon_tpu_torch.ops.topk.topk`) — never ``torch.topk``,
which does not promise the order of ties on CUDA. A tile of at least
``4*k*128`` columns runs the blockmax prefilter (:func:`_blockmax_select`);
a narrower one takes its top-k directly. The per-tile results are merged
with one more K2 top-k over the tile-major concatenation. K2 takes any
``k <= W``, so every k of the search stays on the kernel (the JAX package
falls back to ``lax.top_k`` above 128). The fused gather + top-k K4
(:mod:`lemon_tpu_torch.ops.select`) is not wired in, as in the JAX package.

With a mesh (:mod:`lemon_tpu_torch.core.mesh`, lemon_tpu/knn/index.py:388-432
and :505-522) the database is split over the data axis in contiguous
shards (replicated over the model axis): each rank zero-pads its shard and
searches it with K1 and K2 under the shard's own ``n_valid`` (so a padding
row never competes with a real one), turns its ids global, and all-gathers
the (B, k) candidates over the data group; the
rank-major concatenation is merged with one more K2 top-k. Within a rank's
list equal scores stand in ascending id, and the ranks' id ranges ascend,
so every group of equal scores stands in ascending global id, the order of
the id-sorted concatenation, and K2's first-occurrence rule keeps FAISS's
tie-break. A slot with no row behind it takes the global pad id
``ntotal`` (JAX pins it to 2**30 here; the port pins every pad to the
database size). ``backend="cpp"`` searches on the host with the C++ oracle
(:mod:`lemon_tpu_torch.knn.cpp_backend`).

Left out from the JAX package: the one-hot matmul gathers and index
reconstruction (TPU gather workarounds; plain indexing here), the
second-level select knob and the 8-block tile alignment.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.core.mesh import Mesh, all_gather_rows, pad_to_multiple
from lemon_tpu_torch.ops.scoremax import LANES, scores_blockmax
from lemon_tpu_torch.ops.select import gather_then_topk
from lemon_tpu_torch.ops.topk import topk


def search_q_chunk(default: int = 8192) -> int:
    """Query rows per search chunk (env ``LEMON_TPU_KNN_QCHUNK``). At a
    fixed score-block budget a smaller chunk allows a wider database tile,
    so a 128k-row database stays one tile (lemon_tpu/knn/index.py:48-62)."""
    return int(os.environ.get("LEMON_TPU_KNN_QCHUNK", default))


def auto_tile(n_db: int, n_queries: int, budget_bytes: int = 4 << 30) -> int:
    """Largest database tile (a multiple of 128) whose (queries, tile) fp32
    score block fits ``budget_bytes``, spread evenly over the tiles."""
    max_tile = max(budget_bytes // max(4 * n_queries, 1), LANES)
    n_tiles = max(1, -(-n_db // max_tile))
    return -(-(-(-n_db // n_tiles)) // LANES) * LANES


def numpy_search(xb: np.ndarray, xq: np.ndarray, k: int, metric: str = "ip") -> Tuple[np.ndarray, np.ndarray]:
    """Exact reference search; ties broken by ascending database index."""
    if metric == "ip":
        scores = xq @ xb.T
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    elif metric == "l2":
        scores = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
        order = np.argsort(scores, axis=1, kind="stable")[:, :k]
    else:
        raise ValueError(metric)
    d = np.take_along_axis(scores, order, axis=1)
    return d.astype(np.float32), order.astype(np.int32)


def _blockmax_select(s: torch.Tensor, bmax: torch.Tensor, k: int):
    """Top-k of a masked (B, T) score block given its (B, T/128) block maxima.

    The top-k entries of a row lie in at most k of its 128-column blocks,
    and each such block's max is >= the k-th best value, so the k blocks with
    the largest maxima (ties to the lower block) hold all of them. Sorting
    those block ids puts the (B, k*128) candidates in ascending column order,
    so K2's lower-column tie rule is the database-index tie rule. Returns
    (values, columns local to the tile)."""
    b, t = s.shape
    _, block_ids = topk(bmax, k)
    return gather_then_topk(s.view(b, t // LANES, LANES), block_ids.sort(dim=1).values, k, topk)


def _tile_topk(xq, db, dbsq, start: int, k: int, n_valid: int, metric: str, precision: str):
    """(values, global indices) of the top-k of one database tile."""
    s, bmax = scores_blockmax(xq, db, metric, dbsq, start=start, n_valid=n_valid, precision=precision)
    t = s.shape[1]
    if t >= 4 * k * LANES:
        vals, cols = _blockmax_select(s, bmax, k)
    else:
        # the prefilter only pays when it prunes at least 4x
        kk = min(k, t)
        vals, cols = topk(s, kk)
        if kk < k:  # fewer columns than k: -inf slots, indexed below
            pad = k - kk
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), -torch.inf)], dim=1)
            cols = torch.cat([cols, cols.new_zeros((cols.shape[0], pad))], dim=1)
    return vals, start + cols


def _search_chunk(xq, xb, dbsq, k: int, metric: str, tile: int, n_valid: int, precision: str):
    parts = []
    for start in range(0, xb.shape[0], tile):
        db = xb[start : start + tile]
        sq = None if dbsq is None else dbsq[start : start + tile]
        parts.append(_tile_topk(xq, db, sq, start, k, n_valid, metric, precision))
    if len(parts) == 1:
        vals, idx = parts[0]
    else:
        # tile-major order is ascending database index and each tile's list
        # is tie-ordered by index, so K2's first-occurrence rule keeps the
        # FAISS tie-break across tiles
        cat_v = torch.cat([p[0] for p in parts], dim=1).contiguous()
        cat_i = torch.cat([p[1] for p in parts], dim=1)
        vals, pos = topk(cat_v, k)
        idx = cat_i.gather(1, pos)
    # a -inf slot has no database row behind it: pin its index to n_valid
    idx = torch.where(torch.isneginf(vals), torch.full_like(idx, n_valid), idx)
    return vals, idx


class ExactKnnIndex:
    """Exact kNN index over an embedding matrix: on one device, sharded over
    a mesh's data axis, or on the host (``backend="cpp"``).

    >>> index = ExactKnnIndex(metric="ip", device=torch.device("cuda"))
    >>> index.add(embeddings)           # (N, D), L2-normalised for cosine
    >>> scores, ids = index.search(q, k=5)
    """

    def __init__(self, metric: str = "ip", device: Optional[torch.device] = None, tile: Optional[int] = None,
                 precision: str = "highest", mesh: Optional[Mesh] = None, backend: str = "device"):
        """``device=None`` is the current CUDA card (``resolve_device("cuda")``,
        which raises without one), or the mesh's device; pass
        ``torch.device("cpu")`` to search on the CPU. ``tile=None`` picks the
        widest tile whose score block fits a 4 GiB budget per query chunk; a
        given tile is rounded up to a multiple of 128 (exact search: the tile
        changes no result). ``precision='high'`` is the bf16x3 score product,
        ``'highest'`` fp32 products on the CPU and six bf16 products on the
        card (see ops/scoremax.py). With a ``mesh`` every rank adds the same
        database and searches the same queries, and every rank gets the
        result. ``backend="cpp"`` searches on the host (the device is not
        used); a failed build of the library raises."""
        if metric not in ("ip", "l2") or precision not in ("highest", "high") or backend not in ("device", "cpp"):
            raise ValueError(f"metric {metric!r} / precision {precision!r} / backend {backend!r}")
        if backend == "cpp":
            if mesh is not None:
                raise ValueError("the host C++ backend searches in one process: no mesh")
            device = torch.device("cpu")
        elif device is None:
            device = mesh.device if mesh is not None else resolve_device("cuda")
        if device.type == "cuda" and device.index is None:
            # a tensor on the current card reports its index ("cuda:0"), so
            # adopting it must compare against the indexed device
            device = torch.device("cuda", torch.cuda.current_device())
        self.metric = metric
        self.device = device
        self.tile = tile
        self.precision = precision
        self.mesh = mesh
        self.backend = backend
        self._chunks = []
        self._xb: Optional[torch.Tensor] = None

    @property
    def ntotal(self) -> int:
        self._finalize()
        return 0 if self._xb is None else self._xb.shape[0]

    def add(self, xb) -> None:
        """Host arrays are uploaded at the first search. A float32 tensor
        already on the index's device is adopted as it is (no copy), so a
        caller holding the embeddings on the device shares them."""
        if isinstance(xb, torch.Tensor):
            if self._chunks or self._xb is not None:
                raise ValueError("a device tensor can only be adopted by an empty index")
            if xb.device != self.device or xb.dtype != torch.float32 or xb.dim() != 2:
                raise ValueError(f"adopted database must be 2-D float32 on {self.device}")
            self._xb = xb.contiguous()
            return
        if self._xb is not None and not self._chunks:
            raise ValueError("cannot append host rows to a device-adopted index")
        self._chunks.append(np.ascontiguousarray(xb, dtype=np.float32))
        self._xb = None

    def _finalize(self) -> None:
        if self._xb is None and self._chunks:
            xb = np.concatenate(self._chunks) if len(self._chunks) > 1 else self._chunks[0]
            self._xb = torch.from_numpy(xb).to(self.device)

    def device_array(self) -> torch.Tensor:
        """The whole database on the device, for callers that reuse it."""
        self._finalize()
        return self._xb

    def search(self, xq, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, indices), both (B, k) numpy; ``xq`` numpy or a float32
        tensor on the index's device."""
        self._finalize()
        if self.backend == "cpp":
            from lemon_tpu_torch.knn import cpp_backend

            xq = xq.cpu().numpy() if isinstance(xq, torch.Tensor) else xq
            return cpp_backend.search(self._xb.numpy(), xq, k, self.metric)
        xq = torch.as_tensor(xq, dtype=torch.float32).to(self.device).contiguous()
        if self.mesh is None:
            vals, idx = self._search(xq, self._xb, k, self._xb.shape[0])
        else:
            vals, idx = self._sharded_search(xq, k)
        vals, idx = vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()
        if self.metric == "l2":
            vals = -vals  # internal 'higher is better' -> squared distances
        return vals, idx

    def _search(self, xq: torch.Tensor, xb: torch.Tensor, k: int, n_valid: int):
        """(values, ids) of the top k among the first ``n_valid`` rows of
        ``xb``; a slot with no row behind it is ``-inf`` with id ``n_valid``."""
        n = xb.shape[0]
        q_chunk = search_q_chunk()
        tile = self.tile or auto_tile(n, min(len(xq), q_chunk))
        tile = min(-(-tile // LANES) * LANES, -(-n // LANES) * LANES)
        n_pad = -(-n // tile) * tile
        if n_pad != n:
            xb = torch.cat([xb, xb.new_zeros(n_pad - n, xb.shape[1])])
        dbsq = (xb * xb).sum(1) if self.metric == "l2" else None
        parts = [
            _search_chunk(xq[s : s + q_chunk], xb, dbsq, k, self.metric, tile, n_valid, self.precision)
            for s in range(0, len(xq), q_chunk)
        ]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def _sharded_search(self, xq: torch.Tensor, k: int):
        """This rank's shard searched under its own row count, its ids made
        global, every rank's (B, k) candidates gathered and merged by K2."""
        n, world, rank = self._xb.shape[0], self.mesh.data, self.mesh.rank
        per = max(pad_to_multiple(n, world) // world, 1)
        start = rank * per
        shard = self._xb[start : start + per]
        valid = shard.shape[0]
        if valid < per:  # the last shards are zero-padded to the same size
            shard = torch.cat([shard, shard.new_zeros(per - valid, shard.shape[1])])
        vals, idx = self._search(xq, shard, k, valid)
        idx = torch.where(torch.isneginf(vals), torch.full_like(idx, n), idx + start)
        group = self.mesh.data_group
        cat_v = all_gather_rows(vals[None], group).permute(1, 0, 2).reshape(len(xq), world * k).contiguous()
        cat_i = all_gather_rows(idx[None], group).permute(1, 0, 2).reshape(len(xq), world * k)
        vals, pos = topk(cat_v, k)
        idx = cat_i.gather(1, pos)
        return vals, torch.where(torch.isneginf(vals), torch.full_like(idx, n), idx)


def train_split_exclusion(scores: np.ndarray, idx: np.ndarray, sample_ids: np.ndarray, in_comparison: np.ndarray):
    """The reference's train-split self-exclusion rule: train queries search
    k+1 neighbours; a member of the comparison set drops its first hit
    (itself), any other query drops its last (run_lemon.py:257-263).
    ``in_comparison``: boolean per query row. Returns (B, k) arrays."""
    member = in_comparison[:, None]
    k = idx.shape[1] - 1
    out_s = np.where(member, scores[:, 1:], scores[:, :k])
    out_i = np.where(member, idx[:, 1:], idx[:, :k])
    return out_s, out_i
