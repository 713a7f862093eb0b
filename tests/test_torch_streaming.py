"""The port's image stores (``lemon_tpu_torch.data.streaming``) and native
shard gather (``data/native_loader.py``, ``data/csrc/shard_gather.cc``)
against the JAX package's, bit for bit.

- A store written by either package's ``ShardWriter`` (``.npy`` shards and
  ``manifest.json``) reads the same in the other, through the native gather
  and through the memmap read.
- The native gather equals the numpy memmap read (the plain version) on
  shuffled, negative and repeated ids; a build that fails raises.
- Subsets of a store stay lazy; the deferred render runs at the first pixel
  read and not before.
- ``synthetic_caption`` and ``synthetic_caption_stream`` give the JAX
  package's images, captions and splits.
"""

import os
import stat

import numpy as np
import pytest

from lemon_tpu.data import datasets as jdatasets
from lemon_tpu.data import streaming as jstreaming
from lemon_tpu_torch.data import datasets, native_loader, streaming
from lemon_tpu_torch.data.native_loader import NativeShardGather
from lemon_tpu_torch.data.streaming import (
    IndexedStore,
    LazyRenderUint8Store,
    ShardedUint8Store,
    ShardWriter,
    subset_images,
)


def _images(n, seed=0, shape=(6, 5, 3)):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)


def _write(writer_cls, directory, images, shard_rows, batch):
    w = writer_cls(directory, shard_rows=shard_rows)
    for lo in range(0, len(images), batch):
        w.append(images[lo : lo + batch])
    return w.finish()


def _ids(n, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)[: n // 2]
    return np.concatenate([ids, ids[:7], -rng.integers(1, n + 1, 9), [0, n - 1, -1, -n]])


@pytest.mark.parametrize("shard_rows,batch", [(16, 5), (7, 64), (100, 100)])
def test_shard_writer_round_trip(tmp_path, shard_rows, batch):
    images = _images(53)
    store = _write(ShardWriter, tmp_path / "s", images, shard_rows, batch)
    assert len(store) == 53 and store.shape == images.shape and store.dtype == np.uint8
    assert sorted(p.name for p in (tmp_path / "s").glob("shard_*.npy")) == [
        f"shard_{i:05d}.npy" for i in range(-(-53 // shard_rows))]
    for gather in ("native", "numpy"):
        s = ShardedUint8Store.open(tmp_path / "s", gather=gather)
        np.testing.assert_array_equal(s[np.arange(53)], images)
        np.testing.assert_array_equal(s[5:40:3], images[5:40:3])
        np.testing.assert_array_equal(s[-2], images[-2])


@pytest.mark.parametrize("gather", ["native", "numpy"])
def test_stores_written_by_either_package_read_in_the_other(tmp_path, gather):
    images = _images(70, seed=2)
    _write(jstreaming.ShardWriter, tmp_path / "jax", images, 16, 9)
    _write(ShardWriter, tmp_path / "torch", images, 16, 9)
    ids = _ids(70)
    ours = ShardedUint8Store.open(tmp_path / "jax", gather=gather)
    np.testing.assert_array_equal(ours[ids], images[ids])
    theirs = jstreaming.ShardedUint8Store.open(tmp_path / "torch")
    np.testing.assert_array_equal(theirs[ids], images[ids])
    assert (tmp_path / "jax" / "manifest.json").read_text() == (tmp_path / "torch" / "manifest.json").read_text()


def test_native_gather_equals_the_numpy_read(tmp_path):
    images = _images(300, seed=3, shape=(8, 8, 3))
    _write(ShardWriter, tmp_path / "s", images, 37, 50)
    native = ShardedUint8Store.open(tmp_path / "s", gather="native")
    plain = ShardedUint8Store.open(tmp_path / "s", gather="numpy")
    before = NativeShardGather.gathers
    for seed in range(4):
        ids = _ids(300, seed)
        got = native[ids]
        np.testing.assert_array_equal(got, plain[ids])
        np.testing.assert_array_equal(got, images[ids])
    assert NativeShardGather.gathers == before + 4
    for bad in ([300], [-301]):
        with pytest.raises(IndexError):
            native[np.asarray(bad)]
    assert native[np.zeros(0, np.int64)].shape == (0, 8, 8, 3)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_a_failed_native_build_raises(tmp_path, monkeypatch, compiler):
    """No g++ on PATH, or a g++ that fails: the read raises, nothing falls
    back to the memmap read."""
    _write(ShardWriter, tmp_path / "s", _images(40), 16, 40)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    if compiler == "failing":
        fake = bin_dir / "g++"
        fake.write_text("#!/bin/sh\necho 'g++: error: masked' >&2\nexit 1\n")
        fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path / "build")
    native_loader.library.cache_clear()
    try:
        store = ShardedUint8Store.open(tmp_path / "s")
        match = "g\\+\\+ not found" if compiler == "missing" else "g\\+\\+ failed"
        with pytest.raises(RuntimeError, match=match):
            store[np.arange(40)]
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        native_loader.library.cache_clear()
    np.testing.assert_array_equal(ShardedUint8Store.open(tmp_path / "s", gather="numpy")[[3]], _images(40)[[3]])


def test_unknown_gather_is_refused(tmp_path):
    _write(ShardWriter, tmp_path / "s", _images(4), 16, 4)
    with pytest.raises(ValueError, match="gather"):
        ShardedUint8Store.open(tmp_path / "s", gather="mmap")


def test_indexed_subsets_stay_lazy(tmp_path):
    images = _images(60, seed=4)
    store = _write(ShardWriter, tmp_path / "s", images, 16, 60)
    a = subset_images(store, np.arange(10, 50))
    b = subset_images(a, np.asarray([5, 0, 39, 5]))
    assert isinstance(a, IndexedStore) and isinstance(b, IndexedStore) and b.shape == (4, 6, 5, 3)
    np.testing.assert_array_equal(b[np.arange(4)], images[[15, 10, 49, 15]])
    np.testing.assert_array_equal(b[2], images[49])
    arr = subset_images(images, np.arange(3))
    assert isinstance(arr, np.ndarray) and arr.base is None  # an array is copied
    assert a.fingerprint() is None  # a shard store has no cheap identity


def test_the_lazy_render_defers_until_a_pixel_is_read():
    calls = []
    images = _images(30, seed=5)

    def render():
        calls.append(1)
        return images

    store = LazyRenderUint8Store(render, 30, (6, 5, 3), token="tok")
    view = subset_images(subset_images(store, np.arange(5, 30)), np.arange(0, 25, 2))
    renders = LazyRenderUint8Store.renders
    assert len(view) == 13 and view.shape == (13, 6, 5, 3)
    assert view.fingerprint().startswith("tok|rows:") and calls == []
    assert view.fingerprint() != subset_images(store, np.arange(13)).fingerprint()
    np.testing.assert_array_equal(view[np.arange(13)], images[5:30:2])
    np.testing.assert_array_equal(store[[0, 29]], images[[0, 29]])
    assert calls == [1] and LazyRenderUint8Store.renders == renders + 1
    with pytest.raises(ValueError, match="render"):
        LazyRenderUint8Store(lambda: images[:3], 30, (6, 5, 3), token="bad").materialize()


@pytest.mark.parametrize("name,n,noise_type", [("synthetic_caption", 300, "random"),
                                               ("synthetic_caption_stream", 300, "random"),
                                               ("synthetic_caption_stream", 9000, "noun")])
def test_synthetic_captions_match_jax(tmp_path, monkeypatch, name, n, noise_type):
    """Images, captions and splits bit for bit; the stream's shards are the
    JAX package's cache (one directory, one format), written here by each
    package in its own data root."""
    monkeypatch.setenv("LEMON_TPU_DATA_ROOT", str(tmp_path / "torch"))
    ours = datasets.get_dataset(name, 3, noise_level=0.3, noise_type=noise_type, synthetic_n=n)
    monkeypatch.setenv("LEMON_TPU_DATA_ROOT", str(tmp_path / "jax"))
    theirs = jdatasets.get_dataset(name, 3, noise_level=0.3, noise_type=noise_type, synthetic_n=n)
    for a, b in zip(ours, theirs):
        assert isinstance(a.images, IndexedStore)
        np.testing.assert_array_equal(a.images[np.arange(len(a))], b.images[np.arange(len(b))])
        np.testing.assert_array_equal(a.sentence.astype(str), b.sentence.astype(str))
        np.testing.assert_array_equal(a.gold_sentence.astype(str), b.gold_sentence.astype(str))
    if name.endswith("_stream"):
        rel = f"synthetic_stream/cap_n{n}_s32_seed3"
        ours_dir, theirs_dir = tmp_path / "torch" / rel, tmp_path / "jax" / rel
        assert sorted(os.listdir(ours_dir)) == sorted(os.listdir(theirs_dir))
        for f in sorted(os.listdir(ours_dir)):
            assert (ours_dir / f).read_bytes() == (theirs_dir / f).read_bytes(), f
        # a second call opens the cache it finds
        again = datasets.get_dataset(name, 3, noise_level=0.3, noise_type=noise_type, synthetic_n=n)
        assert isinstance(again[0].images._store, ShardedUint8Store)


def test_ram_and_stream_backings_agree(tmp_path, monkeypatch):
    monkeypatch.setenv("LEMON_TPU_DATA_ROOT", str(tmp_path))
    ram = datasets.get_dataset("synthetic_caption", 0, noise_type="random", synthetic_n=500)
    stream = datasets.get_dataset("synthetic_caption_stream", 0, noise_type="random", synthetic_n=500)
    for a, b in zip(ram, stream):
        np.testing.assert_array_equal(a.images[np.arange(len(a))], b.images[np.arange(len(b))])
        assert (a.sentence == b.sentence).all()
    assert isinstance(stream[0].images._store, streaming.ShardedUint8Store)
