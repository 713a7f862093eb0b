"""Shard-backed and deferred image stores (port of lemon_tpu/data/streaming.py).

A store stands in for the ``images`` array of a split: ``len()``,
``.shape``, ``.dtype`` and a fancy-index ``__getitem__`` that returns a
materialised uint8 batch. ``Split.subset`` keeps a store lazy through
:class:`IndexedStore`, a row indirection, instead of copying pixels.

- :class:`ShardedUint8Store`: a directory of row-aligned ``.npy`` shards plus
  ``manifest.json``, the JAX package's on-disk format, so a store written by
  either package opens in the other. Reads go through the native threaded
  pread gather (``data/native_loader.py``) by default; ``gather="numpy"``
  selects the memmap read, the plain version the tests compare against.
  Nothing falls back from one to the other: a gather that cannot be built
  raises.
- :class:`LazyRenderUint8Store`: a procedural source (the synthetic
  captions' images) rendered at the first pixel read, whose ``fingerprint()``
  is the embedding-cache identity, so a warm run renders nothing.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

GATHERS = ("native", "numpy")


class ShardedUint8Store:
    """A directory of row-aligned uint8 ``.npy`` shards viewed as one array."""

    def __init__(self, shard_paths: Sequence[Path], gather: str = "native"):
        if gather not in GATHERS:
            raise ValueError(f"gather must be one of {GATHERS}, got {gather!r}")
        if not shard_paths:
            raise ValueError("empty store: no shards")
        self.gather = gather
        self._paths = [Path(p) for p in shard_paths]
        self._maps: List[Optional[np.memmap]] = [None] * len(self._paths)
        self._native = None
        rows, row_shape = [], None
        for p in self._paths:
            mm = np.load(p, mmap_mode="r")  # reads the header only
            if mm.dtype != np.uint8:
                raise ValueError(f"{p}: dtype {mm.dtype}, not uint8")
            row_shape = mm.shape[1:] if row_shape is None else row_shape
            if mm.shape[1:] != row_shape:
                raise ValueError(f"{p}: rows of shape {mm.shape[1:]}, the store's are {row_shape}")
            rows.append(mm.shape[0])
        self._row_shape = tuple(row_shape)
        self._offsets = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)

    @classmethod
    def open(cls, directory, gather: str = "native") -> "ShardedUint8Store":
        directory = Path(directory)
        manifest = directory / "manifest.json"
        if manifest.exists():
            return cls([directory / n for n in json.loads(manifest.read_text())["shards"]], gather)
        return cls(sorted(directory.glob("shard_*.npy")), gather)

    def __len__(self) -> int:
        return int(self._offsets[-1])

    @property
    def shape(self):
        return (len(self),) + self._row_shape

    @property
    def dtype(self):
        return np.dtype(np.uint8)

    def _map(self, s: int) -> np.memmap:
        if self._maps[s] is None:
            self._maps[s] = np.load(self._paths[s], mmap_mode="r")
        return self._maps[s]

    def _read_numpy(self, idx: np.ndarray) -> np.ndarray:
        out = np.empty((len(idx),) + self._row_shape, np.uint8)
        shard_of = np.searchsorted(self._offsets, idx, side="right") - 1
        for s in np.unique(shard_of):  # shard by shard, ascending within each
            sel = np.nonzero(shard_of == s)[0]
            local = idx[sel] - self._offsets[s]
            order = np.argsort(local)
            out[sel[order]] = self._map(int(s))[local[order]]
        return out

    def __getitem__(self, idx) -> np.ndarray:
        if isinstance(idx, (int, np.integer)):
            return self[np.asarray([idx])][0]
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(len(self)))
        idx = np.asarray(idx, np.int64).ravel()
        n = len(self)
        if idx.size and (idx.min() < -n or idx.max() >= n):
            raise IndexError(f"index out of range for a store of {n} rows")
        idx = np.where(idx < 0, idx + n, idx)
        if self.gather == "numpy":
            return self._read_numpy(idx)
        if self._native is None:
            from lemon_tpu_torch.data.native_loader import NativeShardGather

            self._native = NativeShardGather(self)
        return self._native.gather(idx)


class IndexedStore:
    """A lazy row selection of a store (``Split.subset`` without a copy)."""

    def __init__(self, store, idx: np.ndarray):
        self._store = store
        self._idx = np.asarray(idx, np.int64)
        self._row_shape = tuple(store.shape[1:])

    def __len__(self) -> int:
        return len(self._idx)

    @property
    def shape(self):
        return (len(self._idx),) + self._row_shape

    @property
    def dtype(self):
        return np.dtype(np.uint8)

    def __getitem__(self, idx) -> np.ndarray:
        if isinstance(idx, (int, np.integer)):
            return self._store[self._idx[int(idx)]]
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(len(self)))
        return self._store[self._idx[np.asarray(idx, np.int64)]]

    def fingerprint(self) -> Optional[str]:
        """The base store's fingerprint and this selection, touching no pixel;
        None where the base store has none (``ClipEncoder.cache_key`` then
        hashes a sample of rows)."""
        base = getattr(self._store, "fingerprint", None)
        token = base() if base is not None else None
        if token is None:
            return None
        return f"{token}|rows:{hashlib.md5(self._idx.tobytes()).hexdigest()}"


class LazyRenderUint8Store:
    """Rows that exist as ``render()`` until a pixel is read: the first read
    renders all of them once (``renders`` counts the renders), later reads
    index the array. ``fingerprint()`` returns ``token``, the generator's
    parameters."""

    renders = 0

    def __init__(self, render, n: int, row_shape, token: str):
        self._render = render
        self._n = int(n)
        self._row_shape = tuple(row_shape)
        self._token = token
        self._data: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self._n

    @property
    def shape(self):
        return (self._n,) + self._row_shape

    @property
    def dtype(self):
        return np.dtype(np.uint8)

    def fingerprint(self) -> str:
        return self._token

    def materialize(self) -> np.ndarray:
        if self._data is None:
            data = np.ascontiguousarray(self._render())
            if data.shape != self.shape or data.dtype != np.uint8:
                raise ValueError(f"render gave {data.dtype} {data.shape}, expected uint8 {self.shape}")
            LazyRenderUint8Store.renders += 1
            self._data = data
            self._render = None  # free what the generator closed over
        return self._data

    def __getitem__(self, idx) -> np.ndarray:
        return self.materialize()[idx]


def is_lazy_store(images) -> bool:
    return isinstance(images, (ShardedUint8Store, IndexedStore, LazyRenderUint8Store))


def subset_images(images, idx: np.ndarray):
    """A row subset of an image source: an array is copied, a store viewed."""
    if images is None:
        return None
    if is_lazy_store(images):
        return IndexedStore(images, idx)
    return images[idx]


class ShardWriter:
    """Appends uint8 batches into ``shard_*.npy`` files of at most
    ``shard_rows`` rows; ``finish()`` writes ``manifest.json`` and opens the
    store."""

    def __init__(self, directory, shard_rows: int = 8192):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.shard_rows = shard_rows
        self._buf: List[np.ndarray] = []
        self._buffered = 0
        self._names: List[str] = []

    def append(self, batch: np.ndarray) -> None:
        batch = np.ascontiguousarray(batch, np.uint8)
        self._buf.append(batch)
        self._buffered += len(batch)
        while self._buffered >= self.shard_rows:
            self._flush(self.shard_rows)

    def _flush(self, rows: int) -> None:
        take, rest, got = [], [], 0
        for b in self._buf:
            if got >= rows:
                rest.append(b)
            elif got + len(b) <= rows:
                take.append(b)
                got += len(b)
            else:
                take.append(b[: rows - got])
                rest.append(b[rows - got :])
                got = rows
        name = f"shard_{len(self._names):05d}.npy"
        np.save(self.dir / name, np.concatenate(take))
        self._names.append(name)
        self._buf = rest
        self._buffered -= got

    def finish(self) -> ShardedUint8Store:
        if self._buffered:
            self._flush(self._buffered)
        (self.dir / "manifest.json").write_text(json.dumps({"shards": self._names}))
        return ShardedUint8Store.open(self.dir)
