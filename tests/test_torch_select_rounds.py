"""The block select of K2's radix variant, P1 and K4 (``csrc/select_rows.cuh``),
restated round by round in ``lemon_tpu_torch.ops.topk.select_rounds_plain``:
the wide first digit over the row, the filter, the list of the threshold
bin (``LIST_CAP``) and its sort, the overflow rounds over the row, the
chunks of ``SORT_CAP``.

On the CPU the restatement is held, exactly (values bit for bit, indices),
to ``topk_plain`` and to the JAX package: ``lemon_tpu.ops.topk.pallas_topk``
in Pallas interpret mode for k <= 128 (the TPU kernel's bound), else
``jax.lax.top_k`` (which orders +0.0 before -0.0, so on signed zeros it is
held on the values only), and, for the P1 and K4 forms, to
``benchmarks/probe_knn_select3.py``'s ``topk_colids`` and
``lemon_tpu.ops.select.fused_gather_topk`` in interpret mode. Its count of
passes over whole rows is held to the design's. The kernels at the
``--knn_k`` grid's shapes run only on the card (marked ``cuda``), against
the plain versions; the JAX package is imported only by the CPU tests.
"""

import numpy as np
import pytest
import torch

from lemon_tpu_torch.ops import select, topk

LANES = 128


def _rows(kind, b, w, seed):
    """Seeded rows: "ties" (multiples of 1/4 in [0, 10)), "gaussian",
    "equal", "neg_inf", "signed_zeros" (-0.5, -0.0, +0.0), "one_bin"
    (3000 distinct values in [1, 1.25), one 11-bit bin larger than the
    list, the rest below 1)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return (rng.integers(0, 40, (b, w)) / 4).astype(np.float32)
    if kind == "gaussian":
        return rng.standard_normal((b, w)).astype(np.float32)
    if kind == "equal":
        return np.full((b, w), 0.25, np.float32)
    if kind == "neg_inf":
        return np.full((b, w), -np.inf, np.float32)
    if kind == "signed_zeros":
        return rng.choice(np.array([-0.5, -0.0, 0.0], np.float32), (b, w))
    x = rng.uniform(0.0, 0.9, (b, w)).astype(np.float32)
    for r in range(b):
        x[r, rng.choice(w, 3000, replace=False)] = 1 + rng.permutation(3000) / 3000 / 4
    return x.astype(np.float32)


# (rows, B, W, k): every case the issue names, at CPU sizes
CASES = [("equal", 3, 300, 37), ("neg_inf", 2, 257, 100), ("signed_zeros", 5, 768, 40), ("one_bin", 2, 5000, 51),
         ("ties", 3, 257, 257), ("ties", 3, 1000, 200), ("ties", 4, 125, 31), ("gaussian", 4, 6528, 51),
         ("ties", 3, 1408, 11), ("gaussian", 2, 5000, 4500)]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_rounds_match_topk_plain_and_the_jax_package():
    import jax
    import jax.numpy as jnp

    from lemon_tpu.ops.topk import pallas_topk

    for rows, b, w, k in CASES:
        x = _rows(rows, b, w, seed=w + k)
        v, i, _ = topk.select_rounds_plain(torch.from_numpy(x), k)
        v0, i0 = topk.topk_plain(torch.from_numpy(x), k)
        assert _same_bits(v, v0) and torch.equal(i, i0), (rows, w, k)
        jv, ji = pallas_topk(jnp.asarray(x), k) if k <= 128 else jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), err_msg=f"{rows} {w} {k}")
        if rows != "signed_zeros":
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji), err_msg=f"{rows} {w} {k}")
    x = torch.from_numpy(_rows("neg_inf", 1, 257, 0))
    assert topk.select_rounds_plain(x, 100)[1][0].tolist() == list(range(100))  # -inf by ascending column


def test_rounds_take_two_passes_unless_a_bin_overflows_the_list():
    """Distinct values: the first histogram and the filter. One 11-bit bin
    of 3000 > LIST_CAP, or the 3200 entries in [8, 10) of tie-heavy rows of
    16000: one more round over the row. All equal (W = 3000):
    the first digit, the key's three other digits and the first column
    digit that varies below W (bits 8-15) over the row, then the filter.
    k above SORT_CAP: two passes a chunk."""
    expect = [("gaussian", 6528, 51, topk.SORT_CAP, 2), ("ties", 6528, 51, topk.SORT_CAP, 2),
              ("ties", 16000, 51, topk.SORT_CAP, 3),
              ("one_bin", 5000, 51, topk.SORT_CAP, 3), ("equal", 3000, 51, topk.SORT_CAP, 6),
              ("gaussian", 5000, 4500, topk.SORT_CAP, 6), ("gaussian", 1024, 200, 64, 8),
              ("ties", 1408, 11, select.MAX_K, 2)]
    assert topk.LIST_CAP == 2048 and topk.SORT_CAP == 2048
    for rows, w, k, cap, passes in expect:
        x = torch.from_numpy(_rows(rows, 3, w, seed=w))
        v, i, n = topk.select_rounds_plain(x, k, sort_cap=cap)
        v0, i0 = topk.topk_plain(x, k)
        assert _same_bits(v, v0) and torch.equal(i, i0), (rows, w, k, cap)
        assert n.tolist() == [passes] * 3, (rows, w, k, cap, n)


def test_rounds_as_p1_and_k4_match_the_jax_probe_and_the_jax_k4():
    """P1 reads the id of each chosen position; K4 selects among k gathered
    blocks (its sort holds select.MAX_K) and rebuilds the global column."""
    import functools
    import types

    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    import benchmarks.probe_knn_select3 as jax_p1
    from lemon_tpu.ops.scoremax import MASKED
    from lemon_tpu.ops.select import fused_gather_topk as jax_fused

    rng = np.random.default_rng(7)
    b, n_blocks, k = 16, 51, 51
    x = (rng.integers(0, 40, (b, n_blocks * LANES)) / 4).astype(np.float32)
    x[0] = -np.inf
    x[1, 3:] = -np.inf
    blocks = np.sort(np.stack([rng.choice(1024, n_blocks, replace=False) for _ in range(b)]), axis=1)
    cid = (blocks[:, :, None] * LANES + np.arange(LANES)).reshape(b, -1).astype(np.int32)
    v, pos, _ = topk.select_rounds_plain(torch.from_numpy(x), k)
    ids = torch.from_numpy(cid).gather(1, pos)
    v0, ids0 = select.topk_colids_plain(torch.from_numpy(x), torch.from_numpy(cid), k)
    assert _same_bits(v, v0) and torch.equal(ids, ids0)
    shim = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    orig, jax_p1.pl = jax_p1.pl, shim
    try:
        jv, ji = jax_p1.topk_colids(jnp.asarray(x), jnp.asarray(cid), k=k, block_rows=8)
    finally:
        jax_p1.pl = orig
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))

    nb = 125  # the block maxima of a 16000-row tile
    for k, rows in ((11, "ties"), (51, "gaussian"), (51, "ties")):
        sb = _rows(rows, 9, nb * LANES, seed=k).reshape(9, nb, LANES)
        sb[0] = -np.inf
        block_ids = np.sort(np.argsort(-sb.max(axis=2), axis=1, kind="stable")[:, :k], axis=1).astype(np.int64)
        cand = torch.from_numpy(sb).gather(1, torch.from_numpy(block_ids)[:, :, None].expand(9, k, LANES))
        v, pos, _ = topk.select_rounds_plain(cand.reshape(9, -1), k, sort_cap=select.MAX_K)
        gid = torch.from_numpy(block_ids).gather(1, pos // LANES) * LANES + pos % LANES
        v0, gid0 = select.fused_gather_topk_plain(torch.from_numpy(sb), torch.from_numpy(block_ids), k)
        assert _same_bits(v, v0) and torch.equal(gid, gid0), (k, rows)
        jv, ji = jax_fused(jnp.asarray(np.where(np.isneginf(sb), MASKED, sb)), jnp.asarray(block_ids, jnp.int32), k,
                           interpret=True)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(gid.numpy(), np.asarray(ji))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


def _misaligned(x):
    """The same values at an address 4 bytes past a 16-byte boundary: the
    kernels stage such rows with plain loads."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


# (W, k) of the --knn_k grid at 20000 B/32 pairs (a 16000-row tile): knn_k
# 10, 30, 50, the 16000-column rows of knn_k 50 with no prefilter; then a
# row wider than shared memory and k above SORT_CAP
CARD_SHAPES = [(1408, 11), (125, 31), (3968, 31), (16000, 51), (6528, 51), (60000, 51), (5000, 4500)]


@pytest.mark.cuda
def test_k2_at_the_knn_k_grid_on_the_card(cuda_device):
    for w, k in CARD_SHAPES:
        for rows in ("ties", "gaussian", "signed_zeros", "equal"):
            x = torch.from_numpy(_rows(rows, 512 if w <= 16000 else 8, w, seed=w)).to(cuda_device)
            x[0] = -torch.inf
            x[1, 5:] = -torch.inf
            v0, i0 = topk.topk_plain(x, k)
            for variant in ("auto", "radix", "warp") if w <= topk.WARP_MAX_W else ("auto", "radix"):
                for xv in (x, _misaligned(x)):
                    v, i = topk.topk(xv, k, variant)
                    torch.cuda.synchronize()
                    assert _same_bits(v, v0) and torch.equal(i, i0), (w, k, rows, variant, xv.data_ptr() % 16)


@pytest.mark.cuda
def test_p1_at_the_knn_k_grid_on_the_card(cuda_device):
    for w, k in [(1408, 11), (125, 31), (3968, 31), (6528, 51), (16000, 51)]:
        for rows in ("ties", "gaussian"):
            x = torch.from_numpy(_rows(rows, 512, w, seed=w + 1)).to(cuda_device)
            x[0] = -torch.inf
            blocks = torch.rand(512, 1024, device=cuda_device).argsort(dim=1)[:, : -(-w // LANES)].sort(dim=1).values
            cid = (blocks.int()[:, :, None] * LANES + torch.arange(LANES, device=cuda_device, dtype=torch.int32))
            cid = cid.reshape(512, -1)[:, :w].contiguous()
            v0, i0 = select.topk_colids_plain(x, cid, k)
            for xv in (x, _misaligned(x)):
                v, i = select.topk_colids(xv, cid, k)
                torch.cuda.synchronize()
                assert _same_bits(v, v0) and torch.equal(i, i0), (w, k, rows)


@pytest.mark.cuda
def test_k4_at_the_knn_k_grid_on_the_card(cuda_device):
    for nb, k in [(125, 11), (125, 31), (125, 51), (1024, 51), (130, 128)]:
        for rows in ("ties", "gaussian", "equal"):
            sb = torch.from_numpy(_rows(rows, 512, nb * LANES, seed=nb + k).reshape(512, nb, LANES)).to(cuda_device)
            sb[0] = -torch.inf
            sb[1, :, 7:] = -torch.inf
            block_ids = topk.topk_plain(sb.amax(2), k)[1].sort(dim=1).values
            v0, i0 = select.fused_gather_topk_plain(sb, block_ids, k)
            for sv in (sb, _misaligned(sb)):
                v, i = select.fused_gather_topk(sv, block_ids, k)
                torch.cuda.synchronize()
                assert _same_bits(v, v0) and torch.equal(i, i0), (nb, k, rows)
