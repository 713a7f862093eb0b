"""K1 (lemon_tpu_torch.ops.scoremax) against the Pallas kernel it replaces.

The plain PyTorch version is held to ``lemon_tpu.ops.scoremax.
fused_scores_blockmax``, which runs in Pallas interpret mode on the CPU.
JAX's finite MASKED sentinel is mapped to -inf before comparing.

Tolerances: scores 1e-5 absolute on unit-norm rows (fp32 summation order
differs between XLA and torch); on inputs that are multiples of 2^-6 every
product and partial sum is exact in fp32, so scores and block maxima must be
equal bit for bit. The CUDA kernel itself runs only on the card (marked
``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.ops.scoremax import MASKED, fused_scores_blockmax
from lemon_tpu_torch.ops import scoremax

CASES = [
    # (B, T, D, start, n_valid): ragged B, start > 0, n_valid < T, 15 blocks
    (10, 2048, 32, 256, 1900),
    (13, 1920, 16, 0, 1920),
    (8, 1024, 24, 512, 10_000),
]


def _inputs(b, t, d, seed, quantized):
    rng = np.random.default_rng(seed)
    if quantized:
        q = rng.integers(-64, 65, (b, d)).astype(np.float32) / 64
        db = rng.integers(-64, 65, (t, d)).astype(np.float32) / 64
    else:
        q = rng.standard_normal((b, d)).astype(np.float32)
        db = rng.standard_normal((t, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
    return q, db, (db * db).sum(1).astype(np.float32)


def _jax(q, db, dbsq, metric, start, n_valid, precision):
    b, t = q.shape[0], db.shape[0]
    s, bm = fused_scores_blockmax(
        jnp.asarray(q), jnp.asarray(db), metric, jnp.asarray(dbsq) if metric == "l2" else None,
        start=start, n_valid=n_valid, precision=precision,
    )
    s = np.asarray(s).reshape(b, -1)[:, :t]  # drop JAX's 8-block alignment padding
    bm = np.asarray(bm)[:, : t // 128]
    return np.where(s == MASKED, -np.inf, s), np.where(bm == MASKED, -np.inf, bm)


def _torch(q, db, dbsq, metric, start, n_valid, precision, device="cpu"):
    s, bm = scoremax.scores_blockmax(
        torch.from_numpy(q).to(device), torch.from_numpy(db).to(device), metric,
        torch.from_numpy(dbsq).to(device) if metric == "l2" else None,
        start=start, n_valid=n_valid, precision=precision,
    )
    return s.cpu().numpy(), bm.cpu().numpy()


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas(case, metric, precision):
    b, t, d, start, n_valid = case
    q, db, dbsq = _inputs(b, t, d, seed=t + d, quantized=False)
    s_ref, bm_ref = _jax(q, db, dbsq, metric, start, n_valid, precision)
    s, bm = _torch(q, db, dbsq, metric, start, n_valid, precision)
    assert s.shape == (b, t) and bm.shape == (b, t // 128)
    masked = (start + np.arange(t)) >= n_valid
    assert np.isneginf(s[:, masked]).all() and np.isfinite(s[:, ~masked]).all()
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bm, bm_ref, rtol=0, atol=1e-5)
    # the block maxima are those of the emitted scores, exactly
    np.testing.assert_array_equal(bm, s.reshape(b, -1, 128).max(axis=2))


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_plain_matches_pallas_exactly_on_exact_inputs(metric, precision):
    b, t, d, start, n_valid = CASES[0]
    q, db, dbsq = _inputs(b, t, d, seed=3, quantized=True)
    s_ref, bm_ref = _jax(q, db, dbsq, metric, start, n_valid, precision)
    s, bm = _torch(q, db, dbsq, metric, start, n_valid, precision)
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(bm, bm_ref)


def _jax_split(x):
    hi = jnp.asarray(x).astype(jnp.bfloat16)
    lo = (jnp.asarray(x) - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return np.asarray(hi.astype(jnp.float32)), np.asarray(lo.astype(jnp.float32))


def _split_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 10.0 ** rng.integers(-6, 6, (n, d))).astype(np.float32)
    x[0, : min(d, 4)] = [0.0, -0.0, 1.0 + 2.0**-8, -(1.0 + 3 * 2.0**-9)][: min(d, 4)]  # signed zeros, RNE ties
    return x


@pytest.mark.parametrize("d", [37, 512, 770])
def test_plain_split_matches_jax_bf16(d):
    """The split pass's plain version: hi = bf16(x), lo = bf16(x - hi), bit
    for bit as JAX rounds them (what the TPU kernel multiplies), and D
    zero-padded to a multiple of 64."""
    x = _split_inputs(9, d, seed=d)
    hi, lo = scoremax.split_bf16(torch.from_numpy(x))
    dp = -(-d // 64) * 64
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == lo.shape == (9, dp)
    ref_hi, ref_lo = _jax_split(x)
    for got, ref in ((hi, ref_hi), (lo, ref_lo)):
        got = got.float().numpy()
        np.testing.assert_array_equal(got[:, :d].view(np.uint32), ref.view(np.uint32))
        assert not got[:, d:].any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        scoremax.scores_blockmax(q, torch.zeros(100, 8))  # T not a multiple of 128
    with pytest.raises(ValueError):
        scoremax.scores_blockmax(q, torch.zeros(128, 8), "l2")  # l2 without db_sqnorm
    with pytest.raises(ValueError):
        scoremax.scores_blockmax(q.double(), torch.zeros(128, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        scoremax.scores_blockmax(torch.zeros(8, 4).T, torch.zeros(128, 8))  # not contiguous
    with pytest.raises(ValueError):
        scoremax.scores_blockmax(q, torch.zeros(128, 8), precision="default")
    with pytest.raises(ValueError):
        scoremax.scores_blockmax(torch.zeros(0, 8), torch.zeros(128, 8), precision="high")  # B = 0
    with pytest.raises(ValueError):
        scoremax.scores_blockmax(q, torch.zeros(128, 9), precision="high")  # D differs
    with pytest.raises(ValueError):
        scoremax.split_bf16(torch.zeros(8, 4).T)  # not contiguous


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, db, dbsq = _inputs(5, 256, 8, seed=0, quantized=False)
    before = scoremax.scores_blockmax.launches
    s, bm = _torch(q, db, dbsq, "ip", 0, 200, "highest")
    s0, bm0 = scoremax.scores_blockmax_plain(torch.from_numpy(q), torch.from_numpy(db), "ip", None, 0, 200)
    np.testing.assert_array_equal(s, s0.numpy())
    np.testing.assert_array_equal(bm, bm0.numpy())
    assert scoremax.scores_blockmax.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 4096, 512, 128, 4000), (77, 640, 37, 0, 600), (129, 256, 770, 0, 256)])
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_kernel_matches_plain_on_the_card(cuda_device, metric, precision, shape):
    b, t, d, start, n_valid = shape
    q, db, dbsq = _inputs(b, t, d, seed=7, quantized=False)
    before = scoremax.scores_blockmax.launches
    s, bm = _torch(q, db, dbsq, metric, start, n_valid, precision, device=cuda_device)
    assert scoremax.scores_blockmax.launches == before + 1
    dev = lambda a: torch.from_numpy(a).to(cuda_device)
    s0, bm0 = scoremax.scores_blockmax_plain(dev(q), dev(db), metric, dev(dbsq), start, n_valid, precision)
    np.testing.assert_allclose(s, s0.cpu().numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bm, s.reshape(b, -1, 128).max(axis=2))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [37, 512, 770])
def test_split_pass_matches_plain_on_the_card(cuda_device, d):
    x = torch.from_numpy(_split_inputs(1000, d, seed=d)).to(cuda_device)
    hi, lo = scoremax.split_bf16(x)
    hi0, lo0 = scoremax.split_bf16_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(hi.view(torch.int16), hi0.view(torch.int16)) and torch.equal(lo.view(torch.int16), lo0.view(torch.int16))
