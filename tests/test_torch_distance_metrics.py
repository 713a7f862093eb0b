"""``lemon_tpu_torch.scoring.distance_metrics`` against
``lemon_tpu.scoring.distance_metrics`` on the same seeded inputs, on the CPU.

Bars: ``pair_distances`` (float64 on both sides) within 1e-12; ``aum_score``
and ``datamap_score`` (the same numpy) exact; ``knn_label_distribution``
within 1e-6 (the port's kNN runs the plain versions of K1 ``ip/highest`` and
K2 on CPU tensors; the float64 vote sums add in the same order, so only the
float32 norm's summation order differs).
"""

import numpy as np
import pytest
import torch

from lemon_tpu.scoring import distance_metrics as jax_dm
from lemon_tpu_torch.scoring import distance_metrics as port_dm

CPU = torch.device("cpu")


def _pairs(seed=0, n=64, d=24):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("dist", ["cosine", "euclidean", "manhattan"])
def test_pair_distances_match_jax(dist):
    a, b = _pairs()
    want = jax_dm.pair_distances(a, b, dist)
    got = port_dm.pair_distances(a, b, dist)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_pair_distances_unknown_metric_raises():
    a, b = _pairs()
    with pytest.raises(NotImplementedError):
        port_dm.pair_distances(a, b, "chebyshev")


def _probs(seed=1, e=6, n=50, c=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((e, n, c))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    # labels 1..c-2 only: 'other' ranges over the observed labels
    return p, rng.integers(1, c - 1, n)


def test_aum_score_matches_jax():
    p, y = _probs()
    np.testing.assert_array_equal(port_dm.aum_score(p, y), jax_dm.aum_score(p, y))


@pytest.mark.parametrize("threshold", [None, 0.3])
def test_datamap_score_matches_jax(threshold):
    p, y = _probs(seed=2)
    p[:, :10] = 0.05  # low, constant confidence: flagged by both rules
    f_jax, s_jax = jax_dm.datamap_score(p, y, threshold)
    f_port, s_port = port_dm.datamap_score(p, y, threshold)
    np.testing.assert_array_equal(f_port, f_jax)
    np.testing.assert_array_equal(s_port, s_jax)
    assert f_port[:10].all()


def _features(seed=3, n=300, d=32, c=6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)) * 2
    y = rng.integers(0, c, n)
    x = (centers[y] + rng.standard_normal((n, d))).astype(np.float32)
    noisy = np.where(rng.random(n) < 0.2, rng.integers(0, c, n), y)
    return x, noisy, c


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("k", [3, 10])
def test_knn_label_distribution_matches_jax(norm, k):
    x, labels, c = _features()
    want = jax_dm.knn_label_distribution(x, labels, c, k=k, norm=norm)
    got = port_dm.knn_label_distribution(x, labels, c, k=k, norm=norm, device=CPU)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [2, 301])
def test_knn_label_distribution_k_out_of_range_raises(k):
    x, labels, c = _features()
    with pytest.raises(ValueError, match="must be in"):
        port_dm.knn_label_distribution(x, labels, c, k=k, device=CPU)


def test_vote_sums_are_bincounts_bit_for_bit():
    """The float64 vote sums add a row's votes in neighbour order, as
    ``np.bincount`` over the flat (row, class) ids does in the JAX package."""
    rng = np.random.default_rng(4)
    n, k, c = 500, 9, 5  # few classes: most rows add several votes into one cell
    nb = rng.integers(0, c, (n, k))
    w = rng.random((n, k)).astype(np.float32)
    got = port_dm.vote_sums(torch.from_numpy(nb), torch.from_numpy(w), c)
    assert got.dtype == torch.float64
    flat = np.arange(n).repeat(k) * c + nb.ravel()
    want = np.bincount(flat, weights=w.ravel().astype(np.float64), minlength=n * c).reshape(n, c)
    np.testing.assert_array_equal(got.numpy(), want)
