"""The port's ExactKnnIndex against the JAX package's tiled search.

The reference is ``lemon_tpu.knn.index._tiled_search(..., use_pallas=True)``
(the TPU composition: fused score+blockmax kernel, Pallas top-k, run in
interpret mode) and the numpy oracle ``numpy_search``. On CPU the port's
wrappers take K1's and K2's plain versions; the search around them (tiles,
prefilter, gather, merge, padding) is the code that runs on the card.

Bars: on real-valued data, scores within 1e-5 and ids exact. On inputs that
are multiples of 2^-6 every score is exact in fp32, so exact ties exist and
the ids must follow the tie rule (lower database index) exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.knn.index import _tiled_search, numpy_search
from lemon_tpu.knn.index import train_split_exclusion as jax_exclusion
from lemon_tpu_torch.knn.index import ExactKnnIndex, _blockmax_select, auto_tile, train_split_exclusion
from lemon_tpu_torch.ops.topk import topk_plain

CASES = [
    # (n_db, d, k, tile): one narrow tile; 5 prefilter tiles + merge;
    # 9 small tiles + merge; one prefilter tile with a padded tail
    (1000, 16, 7, 3584),
    (6700, 32, 3, 1536),
    (2200, 8, 3, 256),
    (6528, 24, 12, 6528),
]


def _data(n_db, d, n_q, seed, quantized):
    rng = np.random.default_rng(seed)
    if quantized:
        xb = rng.integers(-4, 5, (n_db, d)).astype(np.float32) / 64
        xq = rng.integers(-4, 5, (n_q, d)).astype(np.float32) / 64
        return xb, xq
    xb = rng.standard_normal((n_db, d)).astype(np.float32)
    xq = rng.standard_normal((n_q, d)).astype(np.float32)
    return xb / np.linalg.norm(xb, axis=1, keepdims=True), xq / np.linalg.norm(xq, axis=1, keepdims=True)


def _jax_search(xb, xq, k, metric, tile, precision="highest"):
    s, i = _tiled_search(jnp.asarray(xq), jnp.asarray(xb), k=k, metric=metric, tile=tile,
                         n_valid=len(xb), use_pallas=True, precision=precision)
    s = np.asarray(s)
    return (-s if metric == "l2" else s), np.asarray(i)


def _port_search(xb, xq, k, metric, tile, precision="highest"):
    index = ExactKnnIndex(metric=metric, device=torch.device("cpu"), tile=tile, precision=precision)
    index.add(xb)
    return index.search(xq, k)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("case", CASES)
def test_matches_jax_tiled_search(case, metric):
    n_db, d, k, tile = case
    xb, xq = _data(n_db, d, 11, seed=n_db + k, quantized=False)
    s, i = _port_search(xb, xq, k, metric, tile)
    rs, ri = _jax_search(xb, xq, k, metric, tile)
    assert s.shape == (11, k) and i.dtype == np.int32
    np.testing.assert_allclose(s, rs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(i, ri)
    ns, ni = numpy_search(xb, xq, k, metric)
    np.testing.assert_array_equal(i, ni)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("case", CASES[1:])
def test_tie_rule_on_exact_data(case, metric, precision):
    n_db, d, k, tile = case
    xb, xq = _data(n_db, d, 9, seed=k, quantized=True)
    xb[n_db // 2] = xb[1]  # duplicate rows: exact ties across distant ids
    s, i = _port_search(xb, xq, k, metric, tile, precision)
    rs, ri = _jax_search(xb, xq, k, metric, tile, precision)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(i, ri)
    ns, ni = numpy_search(xb, xq, k, metric)
    np.testing.assert_array_equal(s, ns)
    np.testing.assert_array_equal(i, ni)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_k_beyond_ntotal_pads_with_n_valid(metric):
    xb, xq = _data(100, 16, 6, seed=5, quantized=False)
    k = 120
    s, i = _port_search(xb, xq, k, metric, None)
    rs, ri = _jax_search(xb, xq, k, metric, 128)
    pad = np.isinf(s)
    assert (pad == np.isinf(rs)).all() and (pad.sum(1) == k - 100).all()
    assert (np.isneginf(s[pad]) if metric == "ip" else np.isposinf(s[pad])).all()
    assert (i[pad] == 100).all()  # the padding contract: index n_valid
    np.testing.assert_allclose(s[~pad], rs[~pad], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(i[~pad], ri[~pad])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_k_above_128_matches_jax(metric):
    """k = 150 over 400 rows: one narrow tile, so the top-k is taken
    directly. The JAX package leaves its Pallas top-k above k = 128 for
    lax.top_k; the port keeps K2 for every k."""
    xb, xq = _data(400, 16, 7, seed=150, quantized=False)
    s, i = _port_search(xb, xq, 150, metric, None)
    rs, ri = _jax_search(xb, xq, 150, metric, 512)
    assert s.shape == (7, 150)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, rs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [129, 200, 255])
def test_blockmax_select_exact_above_128(k):
    """The prefilter at k in 128..255, on the narrowest tile that takes it
    (4*k*128 columns): quantised scores with ties, a masked tail, and a row
    with fewer finite entries than k, against a whole-row top-k."""
    rng = np.random.default_rng(k)
    t = 4 * k * 128
    s = torch.from_numpy((rng.integers(0, 64, (3, t)) / 8).astype(np.float32))
    s[:, -300:] = -torch.inf
    s[1, 5:] = -torch.inf
    vals, cols = _blockmax_select(s, s.view(3, -1, 128).amax(2), k)
    v0, c0 = topk_plain(s, k)
    assert torch.equal(vals, v0) and torch.equal(cols, c0)


def test_k_above_128_through_the_prefilter_matches_numpy():
    """A whole search whose one tile is wide enough for the prefilter at
    k = 150 (76800 rows), on exact data with duplicated rows."""
    n_db, k = 4 * 150 * 128, 150
    xb, xq = _data(n_db, 8, 3, seed=7, quantized=True)
    xb[n_db // 2] = xb[1]
    s, i = _port_search(xb, xq, k, "ip", n_db)
    ns, ni = numpy_search(xb, xq, k, "ip")
    np.testing.assert_array_equal(s, ns)
    np.testing.assert_array_equal(i, ni)


def test_train_split_self_exclusion_matches_jax():
    """k+1 search of train rows against a comparison subset, then the
    reference's drop-self / drop-last rule."""
    xb, _ = _data(900, 16, 1, seed=9, quantized=False)
    compr_ids = np.random.RandomState(0).choice(np.arange(900), 700, replace=False)
    in_compr = np.zeros(900, bool)
    in_compr[compr_ids] = True
    k = 5
    s, i = _port_search(xb[compr_ids], xb, k + 1, "ip", None)
    rs, ri = _jax_search(xb[compr_ids], xb, k + 1, "ip", 1024)
    s, i = train_split_exclusion(s, i, None, in_compr)
    rs, ri = jax_exclusion(rs, ri, None, in_compr)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, rs, rtol=0, atol=1e-5)
    # members dropped themselves: their first kept neighbour is not their own row
    pos = np.empty(900, np.int64)
    pos[compr_ids] = np.arange(700)
    assert (i[in_compr, 0] != pos[in_compr]).all()


def test_query_chunks_and_device_adoption(monkeypatch):
    monkeypatch.setenv("LEMON_TPU_KNN_QCHUNK", "4")
    xb, xq = _data(700, 16, 10, seed=2, quantized=False)
    index = ExactKnnIndex(metric="ip", device=torch.device("cpu"), tile=256)
    index.add(torch.from_numpy(xb))  # adopted as is
    assert index.device_array().data_ptr() == index._xb.data_ptr() and index.ntotal == 700
    s, i = index.search(torch.from_numpy(xq), 5)
    ns, ni = numpy_search(xb, xq, 5, "ip")
    np.testing.assert_array_equal(i, ni)


def test_auto_tile_fits_the_budget():
    for n, q in ((131072, 8192), (16000, 8192), (1000, 50), (500_000, 8192)):
        tile = auto_tile(n, q)
        assert tile % 128 == 0 and tile * 4 * q <= max(4 << 30, 128 * 4 * q)
        assert -(-n // tile) * tile >= n
    assert auto_tile(131072, 8192) == 131072  # a 128k database stays one tile


@pytest.mark.cuda
def test_index_on_the_card_adopts_device_tensors():
    """``torch.device("cuda")`` names the current card; an encoder built on
    it holds its embeddings on "cuda:<index>", which the index adopts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    xb, xq = _data(700, 16, 10, seed=2, quantized=True)  # exact scores: ids follow the tie rule
    index = ExactKnnIndex(metric="ip", device=torch.device("cuda"))
    index.add(torch.from_numpy(xb).to("cuda"))
    s, i = index.search(torch.from_numpy(xq).to("cuda"), 5)
    np.testing.assert_array_equal(i, numpy_search(xb, xq, 5, "ip")[1])


# --------------------------------------------------------------------------
# the host C++ oracle (knn/cpp_backend.py): the JAX package's source, built
# with g++ by each package; both build here


@pytest.fixture(scope="module")
def cpp_backends():
    from lemon_tpu.knn import cpp_backend as jax_cpp
    from lemon_tpu_torch.knn import cpp_backend

    if not (cpp_backend.available() and jax_cpp.available()):
        pytest.skip("g++ cannot build the host kNN library here")
    return cpp_backend, jax_cpp


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("k", [1, 7, 600])  # 600 > ntotal: padded slots
def test_cpp_backend_matches_jax_and_numpy(cpp_backends, metric, k):
    cpp, jax_cpp = cpp_backends
    xb, xq = _data(500, 32, 40, seed=11, quantized=False)
    s, i = cpp.search(xb, xq, k, metric)
    js, ji = jax_cpp.search(xb, xq, k, metric)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(s, js)  # one source, one set of flags
    kk = min(k, len(xb))
    ns, ni = numpy_search(xb, xq, kk, metric)
    np.testing.assert_array_equal(i[:, :kk], ni)
    np.testing.assert_allclose(s[:, :kk], ns, rtol=1e-5, atol=1e-5)
    if k > len(xb):
        assert (i[:, kk:] == len(xb)).all() and np.isinf(s[:, kk:]).all()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_cpp_pair_distances_match_jax(cpp_backends, metric):
    cpp, jax_cpp = cpp_backends
    xb, xq = _data(40, 32, 40, seed=12, quantized=False)
    a = xb * 3.0  # not unit rows: the cosine normalises
    np.testing.assert_array_equal(cpp.pair_distances(a, xq, metric), jax_cpp.pair_distances(a, xq, metric))
    if metric == "cosine":
        ref = 1.0 - (a * xq).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(xq, axis=1)
    else:
        ref = ((a - xq) ** 2).sum(1)
    np.testing.assert_allclose(cpp.pair_distances(a, xq, metric), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_index_cpp_backend_matches_the_cpu_search(cpp_backends, metric):
    xb, xq = _data(2200, 16, 50, seed=13, quantized=True)  # exact scores: ids follow the tie rule
    index = ExactKnnIndex(metric=metric, backend="cpp")
    assert index.device.type == "cpu"
    index.add(xb[:1000])
    index.add(xb[1000:])
    s, i = index.search(torch.from_numpy(xq), 9)
    ps, pi = _port_search(xb, xq, 9, metric, tile=256)
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_allclose(s, ps, rtol=0, atol=1e-6)
    assert index.ntotal == 2200
    with pytest.raises(ValueError, match="no mesh"):
        ExactKnnIndex(backend="cpp", mesh=object())


def test_cpp_backend_raises_when_it_cannot_build(monkeypatch, tmp_path):
    from lemon_tpu_torch.knn import cpp_backend

    cpp_backend.library.cache_clear()
    monkeypatch.setattr(cpp_backend, "library_path", lambda: tmp_path / "absent.so")
    monkeypatch.setattr(cpp_backend.shutil, "which", lambda name: None)
    try:
        index = ExactKnnIndex(backend="cpp")
        index.add(np.eye(4, dtype=np.float32))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            index.search(np.eye(4, dtype=np.float32), 2)
        assert not cpp_backend.available()
    finally:
        cpp_backend.library.cache_clear()
