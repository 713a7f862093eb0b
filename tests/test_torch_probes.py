"""P1-P4, the probe kernels of ``benchmarks/``, against their JAX twins.

The JAX probes run on the CPU as they are, through an interpret shim set up
by a fixture: each probe module's ``pl`` becomes a namespace whose
``pallas_call`` runs in interpret mode, and ``probe_pallas_int8``'s tiles
shrink to 64 x 128 x 256 (nothing in ``benchmarks/`` changes). The port's
plain versions (what a CPU tensor takes) are held to them:

- P4 ``tiled_matmul``: int8 exact; bf16 within one bf16 ulp (two fp32 sums
  in other orders can round to neighbouring bf16 values).
- P3 ``block_maxima``: ``highest`` exact on inputs whose products and sums
  are exact in fp32 (multiples of 2^-6); 1e-5 absolute on unit rows.
- P2 ``scores_blockmax_t``: 1e-5 absolute at both precisions, JAX's
  ``MASKED`` mapped to -inf.
- P1 ``topk_colids``: values and ids exact against ``topk_colids`` and
  ``topk_pair``, with ties, -inf entries and a row of fewer than k finite
  values.

The CUDA kernels run only on the card (marked ``cuda``): there they are held
to the plain versions (P4 int8 and P1 exact, P4 bf16 one ulp) and P2 and P3
to K1, whose summation order they share, bit for bit. The port's probe
programs (``lemon_tpu_torch/benchmarks``) raise without a card; their
control flow and correctness checks run here at a small size, timed on the
host clock in place of CUDA events.
"""

import functools
import importlib
import json
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import benchmarks.probe_knn_decomp as jax_p3
import benchmarks.probe_knn_select3 as jax_p1
import benchmarks.probe_pallas_int8 as jax_p4
import benchmarks.probe_scoremax2 as jax_p2
from lemon_tpu.ops.scoremax import MASKED
from lemon_tpu_torch.ops import matmul, scoremax, select

LANES = 128


@pytest.fixture
def interpret(monkeypatch):
    """Every probe's ``pallas_call`` in interpret mode; P4's tiles small."""
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    for mod in (jax_p1, jax_p2, jax_p3, jax_p4):
        monkeypatch.setattr(mod, "pl", shim)
    for name, val in (("BM", 64), ("BN", 128), ("BK", 256)):
        monkeypatch.setattr(jax_p4, name, val)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst |out - ref| in units of one bf16 ulp of ref, the ulp taken at no
    less than 2^-8 of ref's largest magnitude (near zero the fp32 sums' own
    rounding exceeds one ulp of the element)."""
    out, ref = out.float(), ref.float()
    mag = torch.maximum(ref.abs(), ref.abs().max() * 2.0**-8)
    return ((out - ref).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


def _mm_inputs(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return rng.integers(-64, 64, (m, k)).astype(np.int8), rng.integers(-64, 64, (k, n)).astype(np.int8)
    return rng.standard_normal((m, k)).astype(np.float32), (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)


def _to_torch_mm(a, b, dtype, device="cpu"):
    dt = torch.int8 if dtype == "int8" else torch.bfloat16
    a_t = torch.from_numpy(a).to(dt).to(device)
    w_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(dt).to(device)  # the probe's (K, N) b as w = b^T
    return a_t, w_t


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_p4_plain_matches_pallas_matmul(interpret, dtype):
    m, k, n = 128, 512, 256
    a, b = _mm_inputs(m, k, n, dtype, seed=4)
    if dtype == "int8":
        ref = np.asarray(jax_p4.pallas_matmul(jnp.asarray(a), jnp.asarray(b), jnp.int32, jnp.int32))
        out = matmul.tiled_matmul(*_to_torch_mm(a, b, dtype))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(ref, a.astype(np.int64) @ b.astype(np.int64))
    else:
        a16, b16 = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        ref = np.array(jax_p4.pallas_matmul(a16, b16, jnp.float32, jnp.bfloat16).astype(jnp.float32))
        out = matmul.tiled_matmul(*_to_torch_mm(a, b, dtype))
        assert out.dtype == torch.bfloat16
        assert bf16_ulps(out, torch.from_numpy(ref)) <= 1


def _knn_inputs(b, t, d, seed, quantized):
    rng = np.random.default_rng(seed)
    if quantized:  # multiples of 2^-6: every product and partial sum exact in fp32
        return (rng.integers(-64, 65, (b, d)).astype(np.float32) / 64,
                rng.integers(-64, 65, (t, d)).astype(np.float32) / 64)
    q = rng.standard_normal((b, d)).astype(np.float32)
    db = rng.standard_normal((t, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True), db / np.linalg.norm(db, axis=1, keepdims=True)


def _unmask(x):
    x = np.asarray(x)
    return np.where(x == MASKED, -np.inf, x)


@pytest.mark.parametrize("precision,quantized", [("highest", True), ("highest", False), ("high", False)])
def test_p3_plain_matches_bmax_only(interpret, precision, quantized):
    b, t, d = 16, 2048, 64
    q, db = _knn_inputs(b, t, d, seed=3, quantized=quantized)
    ref = np.asarray(jax_p3.bmax_only(jnp.asarray(q), jnp.asarray(db), block_rows=8, tile_cols=1024,
                                      precision=precision))
    out = scoremax.block_maxima(torch.from_numpy(q), torch.from_numpy(db), precision).numpy()
    assert out.shape == (b, t // LANES)
    if quantized:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("start,n_valid", [(0, 2048), (256, 1900), (0, 1000)])
def test_p2_plain_matches_fused_t(interpret, precision, start, n_valid):
    b, t, d = 16, 2048, 64
    q, db = _knn_inputs(b, t, d, seed=2, quantized=False)
    s_ref, bt_ref = jax_p2.fused_t(jnp.asarray(q), jnp.asarray(db), start, n_valid=n_valid, block_rows=8,
                                   tile_cols=1024, precision=precision)
    s, bt = scoremax.scores_blockmax_t(torch.from_numpy(q), torch.from_numpy(db), start, n_valid, precision)
    s, bt = s.numpy(), bt.numpy()
    assert s.shape == (b, t) and bt.shape == (t // LANES, b)
    masked = start + np.arange(t) >= n_valid
    assert np.isneginf(s[:, masked]).all() and np.isfinite(s[:, ~masked]).all()
    np.testing.assert_allclose(s, _unmask(s_ref).reshape(b, t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt, _unmask(bt_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bt.T, s.reshape(b, -1, LANES).max(axis=2))


def _colid_inputs(b, n_blocks, nb_total, seed):
    """Tie-heavy candidates of sorted distinct blocks with their global ids;
    row 0 all -inf, row 1 with 3 finite values, row 2 half -inf."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 40, (b, n_blocks * LANES)) / 4).astype(np.float32)
    x[0] = -np.inf
    x[1, 3:] = -np.inf
    x[2, ::2] = -np.inf
    blocks = np.sort(np.stack([rng.choice(nb_total, n_blocks, replace=False) for _ in range(b)]), axis=1)
    cid = (blocks[:, :, None] * LANES + np.arange(LANES)).reshape(b, -1).astype(np.int32)
    return x, cid


@pytest.mark.parametrize("n_blocks,k", [(6, 5), (5, 51), (51, 51)])
def test_p1_plain_matches_topk_colids_and_pair(interpret, n_blocks, k):
    b = 16
    x, cid = _colid_inputs(b, n_blocks, 1024, seed=n_blocks + k)
    vals, ids = select.topk_colids(torch.from_numpy(x), torch.from_numpy(cid), k)
    assert vals.shape == ids.shape == (b, k) and ids.dtype == torch.int32
    for fn in (jax_p1.topk_colids, jax_p1.topk_pair):
        v_ref, i_ref = fn(jnp.asarray(x), jnp.asarray(cid), k=k, block_rows=8)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(i_ref))
    assert np.isneginf(vals[1, 3:].numpy()).all() and np.isfinite(vals[1, :3].numpy()).all()


def test_wrappers_count_no_launch_on_the_cpu_and_refuse_other_devices():
    q, db = torch.zeros(4, 64), torch.zeros(256, 64)
    x, cid = torch.zeros(4, 256), torch.arange(256, dtype=torch.int32).repeat(4, 1)
    a, w = torch.zeros(128, 64, dtype=torch.int8), torch.zeros(128, 64, dtype=torch.int8)
    calls = {scoremax.block_maxima: (q, db), scoremax.scores_blockmax_t: (q, db), select.topk_colids: (x, cid, 5),
             matmul.tiled_matmul: (a, w)}
    for fn, args in calls.items():
        before = fn.launches
        fn(*args)
        assert fn.launches == before
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*(t.to("meta") if isinstance(t, torch.Tensor) else t for t in args))


@pytest.mark.parametrize("bad", [((100, 64), (128, 64)), ((128, 64), (128, 96)), ((128, 60), (128, 60))])
def test_tiled_matmul_refuses_shapes_the_kernel_does_not_take(bad):
    (m, k), (n, k2) = bad
    with pytest.raises(ValueError):
        matmul.tiled_matmul(torch.zeros(m, k, dtype=torch.int8), torch.zeros(n, k2, dtype=torch.int8))
    with pytest.raises(ValueError, match="both int8 or both bf16"):
        matmul.tiled_matmul(torch.zeros(128, 64, dtype=torch.int8), torch.zeros(128, 64, dtype=torch.bfloat16))


# the probes' sizes cut to run on the CPU in a second or two each
SMALL = {
    "probe_pallas_int8": {"SQUARE": 256, "MLP": (256, 128, 384), "PROJ": (128, 128)},
    "probe_knn_decomp": {"N_DB": 8192, "N_Q": 64, "K": 5},
    "probe_scoremax2": {"B": 64, "T": 2048},
    "probe_knn_select3": {"N_DB": 8192, "N_Q": 64, "K": 5, "W": 5 * LANES},
}


def _host_ms(fn, iters=1, warmup=0):
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _host_chain_ms(step, x0, steps=1):
    t0 = time.perf_counter()
    step(x0)
    return (time.perf_counter() - t0) * 1e3


@pytest.mark.parametrize("name", SMALL)
def test_probe_runs_at_a_small_size_on_the_cpu(monkeypatch, capsys, name):
    """The probe end to end with its kernels' plain versions: every variant
    check passes and the last line printed is its results' JSON."""
    mod = importlib.import_module(f"lemon_tpu_torch.benchmarks.{name}")
    for key, val in SMALL[name].items():
        monkeypatch.setattr(mod, key, val)
    monkeypatch.setattr(mod, "require_cuda", lambda _: torch.device("cpu"))
    monkeypatch.setattr(mod, "device_line", lambda: "cpu")
    for key, fn in (("cuda_ms", _host_ms), ("chain_ms", _host_chain_ms)):
        if hasattr(mod, key):
            monkeypatch.setattr(mod, key, fn)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    results = mod.main()
    assert results and json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == results


@pytest.mark.parametrize("name", SMALL)
def test_probe_raises_without_a_card(monkeypatch, name):
    mod = importlib.import_module(f"lemon_tpu_torch.benchmarks.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        mod.main()


# ---------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("mkn", [(128, 64, 128), (256, 192, 384), (512, 4096, 256),
                                 # N = 128 mod 256 over several waves; more tiles than SMs
                                 (2048, 512, 4224), (4096, 256, 4096)])
def test_p4_kernel_matches_plain_on_the_card(cuda_device, dtype, mkn):
    m, k, n = mkn
    a, w = _to_torch_mm(*_mm_inputs(m, k, n, dtype, seed=sum(mkn)), dtype, cuda_device)
    out, ref = matmul.tiled_matmul(a, w), matmul.tiled_matmul_plain(a, w)
    torch.cuda.synchronize()
    if dtype == "int8":
        assert torch.equal(out, ref)
    else:
        assert bf16_ulps(out, ref) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("b,t", [(300, 2048), (129, 1280)])
def test_p2_p3_kernels_match_k1_on_the_card(cuda_device, precision, b, t):
    q, db = (torch.from_numpy(x).to(cuda_device) for x in _knn_inputs(b, t, 96, seed=b, quantized=False))
    s1, bm1 = scoremax.scores_blockmax(q, db, "ip", None, 128, t, precision)
    bm3 = scoremax.block_maxima(q, db, precision)
    s2, bt2 = scoremax.scores_blockmax_t(q, db, 128, t, precision)
    bm0 = scoremax.block_maxima_plain(q, db, precision)
    torch.cuda.synchronize()
    assert torch.equal(bm3, scoremax.scores_blockmax(q, db, precision=precision)[1])
    assert torch.equal(s2, s1) and torch.equal(bt2.T, bm1)
    assert (bm3 - bm0).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,k", [(6, 6), (8, 5), (51, 51), (5, 51)])  # warp kernel, then radix
def test_p1_kernel_matches_plain_on_the_card(cuda_device, n_blocks, k):
    x, cid = (torch.from_numpy(t).to(cuda_device) for t in _colid_inputs(64, n_blocks, 1024, seed=k))
    v, i = select.topk_colids(x, cid, k)
    v0, i0 = select.topk_colids_plain(x, cid, k)
    torch.cuda.synchronize()
    assert torch.equal(v, v0) and torch.equal(i, i0)
