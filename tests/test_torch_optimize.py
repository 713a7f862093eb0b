"""The default (non-strict) hyperparameter fit against the JAX package.

``proxy_lbfgs_device_batch`` re-states optax's ``lbfgs`` with backtracking
line search as the JAX package runs it (``_proxy_lbfgs_device_batch``).
Both run in float32 on the same ``NeighborLogs``, so the trajectories agree
up to summation order: candidates within 1e-4 after 10 steps, and after 100
steps, where rounding can move a candidate along the loss's flat
directions, the proxy loss at each candidate within 1e-5. The components
are those of a 2000-row validation split (a 20000-pair detection) with a
clear gap between clean and mislabelled rows. Where the loss is steep or
nearly flat, a last-bit difference flips one Armijo acceptance and the two
trajectories part for good (on 300 rows with a gap of 0.3, the (1,)*6
restart runs into the clamp in the JAX package and not in the port), so
there the bar is that every restart ends finite inside the clamp. The whole default
fit (batched proxy, device grid, Powell polish) must reach the JAX
package's best F1 within 1e-3, without ``torch.optim``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.scoring.lemon import NeighborLogs as JaxLogs
from lemon_tpu.scoring.lemon import soft_margin_proxy_loss as jax_loss
from lemon_tpu.scoring.optimize import _proxy_arrays, _proxy_lbfgs_device_batch
from lemon_tpu.scoring.optimize import maximize_metric as jax_maximize
from lemon_tpu_torch.scoring.lemon import HPARAM_ORDER, NeighborLogs, component_tensors, soft_margin_proxy_loss
from lemon_tpu_torch.scoring.optimize import maximize_metric, proxy_lbfgs_device_batch

X0S = np.array([[0.0] * 6, [0.5] * 6, [1.0] * 6, [10.0] * 6], np.float32)
ABLATIONS = {"tau_1": (("tau_1_n", "tau_1_m"), ()), "d1": ((), ("beta",))}


def _arrays(n=2000, k=5, seed=0, gap=1.0):
    """Cosine-path-like components; mislabelled rows have distances larger
    by ``gap``."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.3).astype(np.int64)
    return dict(
        d_1=rng.random(n) + gap * y, dists_n=rng.random((n, k)) + gap * y[:, None], D_n=-rng.random((n, k)),
        dists_tr_n=rng.random((n, k)), dists_m=rng.random((n, k)) + gap * y[:, None], D_m=-rng.random((n, k)),
        dists_tr_m=rng.random((n, k)), is_mislabel=y, sset=np.full(n, "val", object),
    )


def _both(arrays, x0s, force_zero, force_one, maxiter):
    """(port candidates, JAX candidates, port loss fn)."""
    y = arrays["is_mislabel"]
    a, ys, fz, fo = _proxy_arrays(JaxLogs(**arrays), y, force_zero, force_one)
    ref = np.asarray(_proxy_lbfgs_device_batch(jnp.asarray(x0s), a, ys, fz, fo, maxiter=maxiter))
    comps = component_tensors(NeighborLogs(**arrays), torch.device("cpu"))
    ys_t = torch.from_numpy(y.astype(np.float32) * 2 - 1)
    fz_t = torch.tensor([n in force_zero for n in HPARAM_ORDER])
    fo_t = torch.tensor([n in force_one for n in HPARAM_ORDER])
    got = proxy_lbfgs_device_batch(torch.from_numpy(x0s), comps, ys_t, fz_t, fo_t, maxiter=maxiter).numpy()
    return got, ref, lambda x: soft_margin_proxy_loss(torch.tensor(np.asarray(x, np.float32)), comps, ys_t, fz_t, fo_t).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_proxy_matches_jax_at_10_steps(seed):
    got, ref, _ = _both(_arrays(seed=seed), X0S, (), (), maxiter=10)
    assert got.shape == (4, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_proxy_loss_matches_jax_at_100_steps(seed):
    got, ref, loss = _both(_arrays(seed=seed), X0S, (), (), maxiter=100)
    np.testing.assert_allclose(loss(got), loss(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("ablation", ["tau_1", "d1"])
def test_ablation_masks_match_jax(ablation):
    force_zero, force_one = ABLATIONS[ablation]
    got, ref, _ = _both(_arrays(), X0S, force_zero, force_one, maxiter=5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # an ablation leaves flat directions, along which rounding drifts sooner
    got, ref, loss = _both(_arrays(), X0S, force_zero, force_one, maxiter=10)
    np.testing.assert_allclose(loss(got), loss(ref), rtol=0, atol=1e-5)
    pinned = [i for i, n in enumerate(HPARAM_ORDER) if n in force_zero + force_one]
    np.testing.assert_array_equal(got[:, pinned], X0S[:, pinned])  # zero gradient: never moved


def test_proxy_loss_and_gradient_match_jax():
    """Inside the domain, at the +-100 clamp and past the exponent clamp."""
    import jax

    arrays = _arrays(n=50, seed=2)
    a, ys, fz, fo = _proxy_arrays(JaxLogs(**arrays), arrays["is_mislabel"], (), ())
    comps = component_tensors(NeighborLogs(**arrays), torch.device("cpu"))
    ys_t = torch.from_numpy(arrays["is_mislabel"].astype(np.float32) * 2 - 1)
    no = torch.zeros(6, dtype=torch.bool)
    for x in ([0.3, -1.0, 2.0, 0.5, 1.5, -0.2], [150.0, 3.0, -120.0, 1.0, 80.0, 0.0], [5.0, 5.0, 90.0, -90.0, 90.0, 90.0]):
        x = np.asarray(x, np.float32)
        v, g = jax.value_and_grad(jax_loss)(jnp.asarray(x), a, ys, fz, fo)
        xt = torch.from_numpy(x[None]).requires_grad_(True)
        vt = soft_margin_proxy_loss(xt, comps, ys_t, no, no)
        vt.sum().backward()
        np.testing.assert_allclose(vt.detach().numpy()[0], np.asarray(v), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy()[0], np.asarray(g), rtol=1e-5, atol=1e-5)


def test_default_fit_matches_jax_without_torch_optim(monkeypatch):
    def no_optim(*args, **kwargs):
        raise AssertionError("the default fit must not construct a torch.optim optimizer")

    monkeypatch.setattr(torch.optim, "LBFGS", no_optim)
    arrays = _arrays(n=400, seed=3)
    grid = {"beta": [0, 5, 20], "gamma": [0, 5, 20], "tau_1": [0, 1, 5], "tau_2": [0, 1, 5]}
    x, f1, thres = maximize_metric(NeighborLogs(**arrays), grid=grid)
    jx, jf1, jthres = jax_maximize(JaxLogs(**arrays), grid=grid)
    assert x.shape == (6,) and np.isfinite(x).all() and np.isfinite(thres)
    assert abs(f1 - jf1) <= 1e-3, (f1, jf1)


def test_far_restarts_end_finite_on_cosine_like_data():
    """tests/test_scoring.py:316-355 for the port: on components with
    D ~ -1 the (10,)*6 restart overflows exp() without the clamps; every
    restart, including x0 = 200, must end finite inside |h| <= 100."""
    rng = np.random.default_rng(3)
    n, k = 15, 5
    arrays = dict(
        d_1=1.0 + 0.2 * rng.random(n), dists_n=0.1 * rng.random((n, k)), D_n=-1.0 + 0.01 * rng.random((n, k)),
        dists_tr_n=0.8 + 0.35 * rng.random((n, k)), dists_m=0.4 * rng.random((n, k)),
        D_m=-1.0 + 0.04 * rng.random((n, k)), dists_tr_m=0.8 + 0.35 * rng.random((n, k)),
        is_mislabel=(rng.random(n) < 0.4).astype(np.int64), sset=np.array(["val"] * n),
    )
    x0s = np.array([[0.0] * 6, [1.0] * 6, [10.0] * 6, [200.0] * 6], np.float32)
    got, ref, loss = _both(arrays, x0s, (), (), maxiter=100)
    assert np.isfinite(got).all() and (np.abs(got) <= 100.0).all()
    assert np.isfinite(loss(got)).all() and np.isfinite(ref).all()
