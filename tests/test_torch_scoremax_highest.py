"""K1 at precision ``highest``: fp32 products on the CPU, the TPU's six bf16
products (``Precision.HIGHEST`` on the MXU) on the card.

The card's kernel multiplies the three bf16 pieces of each operand
(``split_bf16x3``: hi, mid, lo) six times, hi.hi + (hi.mid + mid.hi + hi.lo
+ mid.mid + lo.hi); ``scores_blockmax_bf16x6_plain`` repeats that on any
device. Held here:

- the split against a three-way split written in numpy (round to nearest
  even by bit arithmetic), bit for bit; its first two pieces are
  ``split_bf16``'s, and the three pieces sum to x exactly;
- the bf16x6 plain version within 1e-6 of a float64 product on unit-norm
  rows (the dropped mid.lo, lo.mid and lo.lo are below 2^-26 of each term),
  and bit-equal to the JAX package's ``fused_scores_blockmax(precision=
  "highest")`` on inputs that are multiples of 2^-6 (every piece past hi is
  zero and every sum exact);
- on the card (marked ``cuda``): the kernel within 1e-6 of the bf16x6 plain
  version (fp32 sums in another order), within 1e-5 of the fp32 plain
  version, and no further from float64 than the fp32 plain version plus
  1e-6; ``high``, the same kernel at two pieces, within 1e-5 of its plain
  version; the split pass and the probe variants (P2, P3) bit for bit.
"""

import numpy as np
import pytest
import torch

from lemon_tpu_torch.ops import scoremax

# (B, T, D, start, n_valid), as tests/test_torch_scoremax.py, and the search's D
CASES = [(10, 2048, 32, 256, 1900), (13, 1920, 16, 0, 1920), (8, 1024, 24, 512, 10_000), (16, 1024, 512, 0, 1000)]
F64_TOL = 1e-6


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns, rounded to nearest even (finite x)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _numpy_split3(x: np.ndarray):
    hi = _bf16_bits(x)
    rest = x - _bf16_value(hi)
    mid = _bf16_bits(rest)
    lo = _bf16_bits(rest - _bf16_value(mid))
    return hi, mid, lo


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def _split_inputs(n, d, seed):
    """Normal values over six decades of magnitude, away from subnormals."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * 10.0 ** rng.uniform(-3, 3, (n, 1))).astype(np.float32)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _f64_scores(q, db, dbsq, metric):
    s = q.astype(np.float64) @ db.astype(np.float64).T
    if metric == "l2":
        qsq = (q.astype(np.float64) ** 2).sum(1, keepdims=True)
        s = -((qsq - 2.0 * s) + dbsq.astype(np.float64)[None, :])
    return s


def test_split_bf16x3_plain_is_a_numpy_three_way_split():
    for n, d in ((5, 37), (64, 512), (3, 770)):
        x = _split_inputs(n, d, seed=d)
        pieces = scoremax.split_bf16x3_plain(torch.from_numpy(x))
        dp = scoremax.padded_depth(d)
        for got, want in zip(pieces, _numpy_split3(x)):
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, dp)
            np.testing.assert_array_equal(_bits(got)[:, :d], want)
            assert not _bits(got)[:, d:].any()  # zero padding


def test_split_bf16x3_extends_split_bf16_and_sums_to_x_exactly():
    for n, d in ((7, 40), (32, 512)):
        x = torch.from_numpy(_split_inputs(n, d, seed=n))
        hi, mid, lo = scoremax.split_bf16x3(x)  # CPU tensors take the plain version
        hi2, lo2 = scoremax.split_bf16(x)
        assert torch.equal(_bits_t(hi), _bits_t(hi2)) and torch.equal(_bits_t(mid), _bits_t(lo2))
        total = hi.double() + mid.double() + lo.double()
        assert torch.equal(total[:, :d], x.double()) and not total[:, d:].any()
        # hi alone and hi + mid are not exact on these inputs: each piece carries bits
        assert not torch.equal(hi[:, :d].double(), x.double())
        assert not torch.equal((hi.double() + mid.double())[:, :d], x.double())


def test_split_bf16x3_rejects_what_the_split_pass_does_not_take():
    for bad in (torch.zeros(8, 4).T, torch.zeros(8, 4, dtype=torch.float64), torch.zeros(8)):
        with pytest.raises(ValueError, match="split_bf16x3"):
            scoremax.split_bf16x3(bad)


def test_bf16x6_plain_is_within_1e6_of_float64():
    rng = np.random.default_rng(11)
    for b, t, d, start, n_valid in CASES:
        q, db = _unit_rows(rng, b, d), _unit_rows(rng, t, d)
        dbsq = (db * db).sum(1).astype(np.float32)
        for metric in ("ip", "l2"):
            s, bm = scoremax.scores_blockmax_bf16x6_plain(torch.from_numpy(q), torch.from_numpy(db), metric,
                                                          torch.from_numpy(dbsq) if metric == "l2" else None,
                                                          start, n_valid)
            s = s.numpy()
            valid = start + np.arange(t) < n_valid
            assert np.isneginf(s[:, ~valid]).all()
            np.testing.assert_allclose(s[:, valid], _f64_scores(q, db, dbsq, metric)[:, valid], rtol=0, atol=F64_TOL)
            np.testing.assert_array_equal(bm.numpy(), s.reshape(b, -1, 128).max(axis=2))


def test_bf16x6_plain_equals_jax_highest_on_quantised_inputs():
    import jax.numpy as jnp

    from lemon_tpu.ops.scoremax import MASKED, fused_scores_blockmax

    rng = np.random.default_rng(5)
    for b, t, d, start, n_valid in CASES[:3]:
        q = rng.integers(-64, 65, (b, d)).astype(np.float32) / 64
        db = rng.integers(-64, 65, (t, d)).astype(np.float32) / 64
        dbsq = (db * db).sum(1).astype(np.float32)
        for metric in ("ip", "l2"):
            s_ref, bm_ref = fused_scores_blockmax(jnp.asarray(q), jnp.asarray(db), metric,
                                                  jnp.asarray(dbsq) if metric == "l2" else None, start=start,
                                                  n_valid=n_valid, precision="highest")
            s_ref = np.asarray(s_ref).reshape(b, -1)[:, :t]  # drop JAX's 8-block alignment padding
            bm_ref = np.asarray(bm_ref)[:, : t // 128]
            s, bm = scoremax.scores_blockmax_bf16x6_plain(torch.from_numpy(q), torch.from_numpy(db), metric,
                                                          torch.from_numpy(dbsq) if metric == "l2" else None,
                                                          start, n_valid)
            np.testing.assert_array_equal(s.numpy(), np.where(s_ref == MASKED, -np.inf, s_ref))
            np.testing.assert_array_equal(bm.numpy(), np.where(bm_ref == MASKED, -np.inf, bm_ref))


def test_cpu_highest_stays_fp32_products_and_launches_nothing():
    rng = np.random.default_rng(2)
    q, db = torch.from_numpy(_unit_rows(rng, 16, 512)), torch.from_numpy(_unit_rows(rng, 1024, 512))
    before = (scoremax.scores_blockmax.launches, scoremax.scores_blockmax.launches_highest)
    s, bm = scoremax.scores_blockmax(q, db, "ip", None, 0, 1000, "highest")
    assert (scoremax.scores_blockmax.launches, scoremax.scores_blockmax.launches_highest) == before
    s32, bm32 = scoremax.scores_blockmax_plain(q, db, "ip", None, 0, 1000, "highest")
    assert torch.equal(s, s32) and torch.equal(bm, bm32)
    fin = torch.isfinite(s)
    assert torch.equal(s[fin], (q @ db.T)[fin])
    s6, _ = scoremax.scores_blockmax_bf16x6_plain(q, db, "ip", None, 0, 1000)
    gap = (s6 - s)[fin].abs().max().item()
    assert 0 < gap <= F64_TOL  # another function, within the bar
    with pytest.raises(ValueError, match="CUDA card"):  # the main kernel alone has no plain version
        scoremax.launch_split(scoremax.split_bf16x3(q), scoremax.split_bf16x3(db))


def _instance_products(src: str, pieces: int) -> int:
    """The wgmma products a 32-deep step of the kernel's main loop runs in
    the instance with ``pieces`` pieces: the ``if constexpr (PIECES == 3)``
    block counts only at three."""
    loop = src[src.index("wgmma_fence();"):src.index("wgmma_commit();")]
    head, _, block = loop.partition("if constexpr (PIECES == 3) {")
    return head.count("wgmma_m64n128k16(") + (block.count("wgmma_m64n128k16(") if pieces == 3 else 0)


@pytest.mark.parametrize("precision,pieces,products", [("high", 2, 3), ("highest", 3, 6)])
def test_limits_benchmark_edits_the_kernel_it_times(precision, pieces, products):
    """``benchmarks/k1_limits.py`` builds edited copies of the kernel and
    times each at both precisions: the edits must still find their lines in
    the instance of each piece count."""
    from lemon_tpu_torch.benchmarks.k1_limits import PRECISIONS, variant_sources
    from lemon_tpu_torch.ops import _build

    assert precision in PRECISIONS
    src = (_build.CSRC / "scoremax.cu").read_text()
    builds = variant_sources(src)
    assert builds["as_built"] == src and len(set(builds.values())) == 4
    assert _instance_products(src, pieces) == products
    assert _instance_products(builds["no_loads"], pieces) == products
    assert "continue;" in builds["no_loads"] and "continue;" not in src
    assert _instance_products(builds["one_product"], pieces) == 1  # hi.hi alone
    direct = builds["direct_store"]  # every product kept, s stored from registers
    assert _instance_products(direct, pieces) == products
    assert "__stcs(" in direct and "tma_store_2d(" not in direct and "maps.s_out = s;" in direct
    last = {"high": "wgmma_m64n128k16(acc_x, q1, d0);", "highest": "wgmma_m64n128k16(acc_x, q2, d0);"}[precision]
    with pytest.raises(ValueError, match="no longer holds"):
        variant_sources(src.replace(last, ""))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


# (B, T, D, start, n_valid): odd B, D of 37 and 770, start > 0; then B not a
# multiple of 128 over more tiles than the card has SMs, so that the
# persistent walk wraps
CARD_SHAPES = [(300, 4096, 512, 128, 4000), (77, 640, 37, 0, 600), (129, 256, 770, 0, 256),
               (1000, 128 * 140, 96, 0, 128 * 140 - 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_kernel_matches_both_plain_versions_on_the_card(cuda_device, precision):
    """``highest`` within 1e-6 of its bf16x6 plain version, 1e-5 of the fp32
    one and no further from float64 than the latter plus 1e-6; ``high``
    within 1e-5 of its plain version (the same bf16x3 products, fp32 sums in
    another order). One item a precision, the shapes inside: the suite's
    wall depends on each file's item count."""
    for b, t, d, start, n_valid in CARD_SHAPES:
        rng = np.random.default_rng(7)
        q, db = (torch.from_numpy(_unit_rows(rng, n, d)).to(cuda_device) for n in (b, t))
        dbsq = (db * db).sum(1)
        for metric in ("ip", "l2"):
            args = (q, db, metric, dbsq if metric == "l2" else None, start, n_valid)
            before = (scoremax.scores_blockmax.launches, scoremax.scores_blockmax.launches_highest)
            s, bm = scoremax.scores_blockmax(*args, precision)
            assert (scoremax.scores_blockmax.launches, scoremax.scores_blockmax.launches_highest) == (
                before[0] + 1, before[1] + (precision == "highest"))
            s32, _ = scoremax.scores_blockmax_plain(*args, precision)
            fin = torch.isfinite(s32)
            assert torch.equal(torch.isfinite(s), fin)
            assert (s - s32)[fin].abs().max().item() <= 1e-5
            assert torch.equal(bm, s.view(b, -1, 128).amax(2))
            if precision == "high":
                continue
            s6, _ = scoremax.scores_blockmax_bf16x6_plain(*args)
            assert (s - s6)[fin].abs().max().item() <= 1e-6
            s64 = torch.from_numpy(_f64_scores(q.cpu().numpy(), db.cpu().numpy(), dbsq.cpu().numpy(), metric))
            s64 = s64.to(cuda_device)
            err, err32 = ((x.double() - s64)[fin].abs().max().item() for x in (s, s32))
            assert err <= err32 + F64_TOL


@pytest.mark.cuda
def test_split_pass_x3_and_probe_variants_match_on_the_card(cuda_device):
    for d in (37, 512, 770):
        x = torch.from_numpy(_split_inputs(1000, d, seed=d)).to(cuda_device)
        for got, want in zip(scoremax.split_bf16x3(x), scoremax.split_bf16x3_plain(x)):
            assert torch.equal(_bits_t(got), _bits_t(want))
    rng = np.random.default_rng(8)
    q, db = (torch.from_numpy(_unit_rows(rng, n, 512)).to(cuda_device) for n in (200, 2048))
    s, bm = scoremax.scores_blockmax(q, db, "ip", None, 0, 2000, "highest")
    s2, bm_t = scoremax.scores_blockmax_t(q, db, 0, 2000, "highest")
    assert torch.equal(s2, s) and torch.equal(bm_t.T, bm)
    _, bm_all = scoremax.scores_blockmax(q, db, "ip", None, 0, None, "highest")
    assert torch.equal(scoremax.block_maxima(q, db, "highest"), bm_all)
