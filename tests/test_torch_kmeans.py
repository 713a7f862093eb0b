"""``lemon_tpu_torch.ops.kmeans.KMeans`` and caption clustering against the
JAX package's, on the CPU.

Both draw the subsample and the initial centroids from one
``np.random.default_rng(seed)`` and run exactly ``max_iter`` Lloyd steps, so
on the same input the labels are identical and the centroids agree within
1e-5 (the port sums in float64 and rounds once, JAX sums in fp32). Caption clustering runs the tiny CLIP of
both packages on one set of weights (``from_flax_params``).
"""

import numpy as np
import pytest
import torch

from lemon_tpu.ops.kmeans import KMeans as JaxKMeans
from lemon_tpu_torch.ops import kmeans as port_kmeans

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(seed=0, n=600, d=16, k=6, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 4
    y = rng.integers(0, k, n)
    return (centers[y] + spread * rng.standard_normal((n, d))).astype(np.float32), y


def _fit_both(x, **kw):
    jax_km = JaxKMeans(**kw).fit(x)
    port_km = port_kmeans.KMeans(**kw, device=CPU).fit(x)
    return jax_km, port_km


def test_blobs_match_jax():
    x, _ = _blobs()
    jax_km, port_km = _fit_both(x, n_clusters=6, n_init=3, max_iter=25, seed=7)
    np.testing.assert_allclose(port_km.centroids, jax_km.centroids, rtol=0, atol=1e-5)
    labels = port_km.predict(x)
    np.testing.assert_array_equal(labels, jax_km.predict(x))
    assert len(np.unique(labels)) == 6


def test_subsample_draws_the_same_rows():
    """n above n_clusters * max_points_per_centroid: both packages fit on the
    same subsample, so with one Lloyd step the centroids are the means of
    the same draws."""
    x, _ = _blobs(seed=1, n=500)
    kw = dict(n_clusters=4, n_init=2, max_iter=1, max_points_per_centroid=10, seed=3)
    jax_km, port_km = _fit_both(x, **kw)
    np.testing.assert_allclose(port_km.centroids, jax_km.centroids, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port_km.predict(x), jax_km.predict(x))
    # the draws: a subsample of 40 rows, then 4 initial centroids per restart
    rng = np.random.default_rng(3)
    sub = x[rng.choice(len(x), 40, replace=False)]
    inits = np.stack([sub[rng.choice(40, 4, replace=False)] for _ in range(2)])
    c, _ = port_kmeans._lloyd_restarts(torch.from_numpy(sub), torch.from_numpy(inits), 1)
    assert any(np.array_equal(port_km.centroids, ci) for ci in c.numpy())


def test_empty_cluster_keeps_its_centroid():
    """Duplicate rows drawn as two initial centroids: the second never wins
    a tie (argmin takes the first) and keeps its place, in both packages."""
    x = np.repeat(np.array([[0.0, 0.0], [10.0, 10.0], [20.0, 0.0]], np.float32), 5, axis=0)
    jax_km, port_km = _fit_both(x, n_clusters=4, n_init=1, max_iter=5, seed=0)
    np.testing.assert_allclose(port_km.centroids, jax_km.centroids, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port_km.predict(x), jax_km.predict(x))
    inits = x[np.random.default_rng(0).choice(len(x), 4, replace=False)]
    (c,), _ = port_kmeans._lloyd_restarts(torch.from_numpy(x), torch.from_numpy(inits[None]), 5)
    counts = np.bincount(port_km.predict(x), minlength=4)
    empty = np.flatnonzero(counts == 0)
    assert len(empty) >= 1
    np.testing.assert_array_equal(c.numpy()[empty], inits[empty])


def test_lloyd_step_is_correctly_rounded():
    """One Lloyd step of three restarts on rows crowded about one direction
    (as a random-init tower's embeddings are) equals the float64 step
    rounded to fp32 where the port rounds: the products and sums over D and
    N, whatever order a device adds them in."""
    rng = np.random.default_rng(5)
    d, k = 64, 12
    x = rng.standard_normal(d) + 0.35 * rng.standard_normal((400, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    inits = np.stack([x[rng.choice(len(x), k, replace=False)] for _ in range(3)])
    got, _ = port_kmeans._lloyd_restarts(torch.from_numpy(x), torch.from_numpy(inits), 1)
    x64 = x.astype(np.float64)
    x_sq = (x64**2).sum(1).astype(np.float32)
    for r, c in enumerate(inits):
        c64 = c.astype(np.float64)
        logits = (x64 @ c64.T).astype(np.float32)
        dist = x_sq[:, None] - np.float32(2.0) * logits + (c64**2).sum(1).astype(np.float32)[None]
        labels = dist.argmin(1)
        want = c.copy()
        for j in np.unique(labels):
            want[j] = x64[labels == j].mean(0).astype(np.float32)
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_predict_before_fit_raises():
    with pytest.raises(AssertionError, match="fit first"):
        port_kmeans.KMeans(n_clusters=2, device=CPU).predict(np.zeros((3, 2), np.float32))


def test_cluster_caption_text_matches_jax(tmp_path):
    from lemon_tpu.data.clustering import cluster_caption_text as jax_cluster
    from lemon_tpu.models.clip import ClipConfig, init_params
    from lemon_tpu.models.encoder import ClipEncoder as JaxEncoder
    from lemon_tpu_torch.data.clustering import cluster_caption_text
    from lemon_tpu_torch.models.clip import ClipConfig as PortConfig, ClipModel
    from lemon_tpu_torch.models.convert import from_flax_params
    from lemon_tpu_torch.models.encoder import ClipEncoder

    jax_model, params = init_params(ClipConfig.tiny(), seed=3)
    jax_enc = JaxEncoder(jax_model, params, batch_size=32)
    model = ClipModel(PortConfig.tiny())
    model.load_state_dict(from_flax_params(params))
    port_enc = ClipEncoder(model, CPU, batch_size=32)
    rng = np.random.default_rng(5)
    words = ["bird", "car", "house", "tree", "dog", "boat"]
    texts = [f"a {['small', 'red', 'old'][rng.integers(3)]} {words[rng.integers(6)]} in a scene" for _ in range(90)]
    jkm, jlabels = jax_cluster(texts, n_clusters=8, encoder=jax_enc, seed=2)
    pkm, plabels = cluster_caption_text(texts, n_clusters=8, encoder=port_enc, seed=2)
    np.testing.assert_array_equal(plabels, jlabels)
    np.testing.assert_allclose(pkm.km.centroids, jkm.km.centroids, rtol=0, atol=1e-5)
    assert pkm.km.device == CPU
    held_out = ["a red dog in a scene", "an old boat in a scene", "a small tree in a scene"]
    np.testing.assert_array_equal(pkm.predict(held_out), jkm.predict(held_out))
