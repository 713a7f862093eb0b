"""The warp select of K2's warp variant, P1 on narrow rows and K4's k <= 8
path (``csrc/select_rows.cuh``, ``warp_select``), restated in
``lemon_tpu_torch.ops.topk.warp_select_plain``: the lane layouts (32 lanes
by CAP registers, scalar and 16-byte loads), the k-th largest lane maximum
as the lower bound, the list ranked by counting in the packed order (ties
to the lower column), the rise of the bound by counts and the ties path.

On the CPU the restatement is held, exactly (values bit for bit, indices),
to ``topk_plain`` at a few rows of every instance's width, to the JAX
package's ``pallas_topk`` in Pallas interpret mode and ``jax.lax.top_k``
(which orders +0.0 before -0.0, so on signed zeros it is held on the
values only), and, in K4's layout, to ``fused_gather_topk`` in interpret
mode. The kernels themselves run only on the card: ``test_torch_topk.py``
and ``test_torch_select.py`` hold every instance to the plain versions
there (marked ``cuda``).
"""

import collections

import numpy as np
import torch

from lemon_tpu_torch.ops import select, topk

LANES = 128


def _rows(b, w, seed):
    """Seeded rows: tie-heavy (multiples of 1/4 in [0, 10)), Gaussian, one
    all -inf, one with 3 finite entries, one of +-0 and -0.5, one all equal."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 40, (b, w)) / 4).astype(np.float32)
    x[b // 2 :] = rng.standard_normal((b - b // 2, w))
    x[0] = -np.inf
    x[1, 3:] = -np.inf
    x[2] = rng.choice(np.array([-0.5, -0.0, 0.0], np.float32), w)
    x[3] = 0.25
    return x


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# (widths, k) at every instance of K2's warp variant (CAP by W): widths that
# are multiples of 4 (also taken by the 16-byte layout) and not
WIDTHS_AND_KS = {4: ((128, 125, 9), (1, 6, 9, 31, 125)), 8: ((256, 199), (2, 6, 40)), 16: ((512, 301), (6, 24, 257)),
                 24: ((768, 701), (5, 6, 51)), 32: ((1024, 999), (6, 32, 200))}


def test_restatement_matches_topk_plain_at_every_instance():
    paths = collections.Counter()
    for cap, (widths, ks) in WIDTHS_AND_KS.items():
        for w in widths:
            x = torch.from_numpy(_rows(12, w, seed=w))
            for k in ks:
                if k > w:
                    continue
                assert topk.warp_cap(w) == cap, w
                v0, i0 = topk.topk_plain(x, k)
                for vec in (False, True) if w % 4 == 0 else (False,):
                    v, i, p = topk.warp_select_plain(x, k, vec)
                    assert _same_bits(v, v0) and torch.equal(i, i0), (w, k, vec, p)
                    paths.update(p.tolist())
    assert set(paths) == {"list", "bisect", "ties"}, paths


def test_lane_layouts_and_the_tie_rule():
    """Columns rise with a lane's registers and, within one register (or
    float4) index, with the lane; equal keys go to the lower column, -inf
    entries by ascending column, +-0 tie and keep their signs."""
    for cap, vec in ((4, False), (4, True), (24, True), (32, False)):
        cols = topk.lane_columns(cap, vec)
        assert sorted(cols.ravel().tolist()) == list(range(32 * cap))
        q = 4 if vec else 1
        order = [cols[lane, u * q + i] for u in range(cap // q) for lane in range(32) for i in range(q)]
        assert order == list(range(32 * cap)), (cap, vec)
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf, 0.5, -0.0, 0.0, -0.0]])
    v, i, _ = topk.warp_select_plain(x, 10)
    assert i.tolist() == [[1, 2, 4, 0, 6, 7, 8, 9, 3, 5]]
    assert torch.signbit(v[0, 5:8]).tolist() == [True, False, True]
    assert topk.warp_list_cap(6) == 64 and topk.warp_list_cap(65) == 128 and topk.warp_list_cap(1000) == 1024


def test_prefilter_and_paths():
    """The k-th largest lane maximum leaves a short list on distinct and on
    tie-heavy rows at the main path's shapes; k above 32 (no prefilter)
    bisects; a row all equal, all -inf, of zeros or with fewer finite
    entries than k takes the ties path."""
    rng = np.random.default_rng(5)
    for w, k in ((125, 6), (768, 6), (640, 5), (1024, 16)):
        for x in ((rng.integers(0, 40, (16, w)) / 4).astype(np.float32), rng.standard_normal((16, w), np.float32)):
            assert set(topk.warp_select_plain(torch.from_numpy(x), k, w % 4 == 0)[2]) == {"list"}, (w, k)
    x = rng.standard_normal((4, 640), np.float32)
    assert set(topk.warp_select_plain(torch.from_numpy(x), 51, True)[2]) == {"bisect"}
    x = np.stack([np.full(300, 0.25), np.full(300, -np.inf), np.zeros(300), np.full(300, -np.inf)]).astype(np.float32)
    x[3, 200:203] = 1.0
    v, i, p = topk.warp_select_plain(torch.from_numpy(x), 70)
    assert p.tolist() == ["ties"] * 4 and (i[:3] == torch.arange(70)).all()
    assert i[3].tolist() == [200, 201, 202, *range(67)]


def test_restatement_matches_the_jax_package():
    import jax
    import jax.numpy as jnp

    from lemon_tpu.ops.topk import pallas_topk

    # the TPU kernel at the main path's shapes (its interpreter compiles each
    # shape: a few seconds), lax.top_k at the others
    for w, k, pallas in ((125, 6, True), (768, 6, True), (93, 8, False), (256, 40, False), (1024, 200, False)):
        x = _rows(10, w, seed=3 * w)
        v, i, _ = topk.warp_select_plain(torch.from_numpy(x), k, w % 4 == 0)
        jv, ji = pallas_topk(jnp.asarray(x), k, interpret=True) if pallas else jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), err_msg=f"{w} {k}")
        keep = np.ones(len(x), bool)
        keep[2] = pallas  # +-0: lax.top_k puts +0.0 first, so it agrees with the port on the values only there
        np.testing.assert_array_equal(i.numpy()[keep], np.asarray(ji)[keep], err_msg=f"{w} {k}")


def test_restatement_as_k4_matches_the_jax_k4():
    """K4's warp path: the k gathered blocks in 4 registers a lane for each
    block slot, scalar (columns s*128 + lane + 32q) or 16-byte (s*128 +
    4 lane + q)."""
    import jax.numpy as jnp

    from lemon_tpu.ops.scoremax import MASKED
    from lemon_tpu.ops.select import fused_gather_topk as jax_fused

    b, nb = 9, 16
    for k in range(1, 9):
        sb = _rows(b, nb * LANES, seed=k).reshape(b, nb, LANES)
        block_ids = np.sort(np.argsort(-sb.max(axis=2), axis=1, kind="stable")[:, :k], axis=1).astype(np.int64)
        cand = torch.from_numpy(sb).gather(1, torch.from_numpy(block_ids)[:, :, None].expand(b, k, LANES))
        v0, gid0 = select.fused_gather_topk_plain(torch.from_numpy(sb), torch.from_numpy(block_ids), k)
        for vec in (False, True):
            v, pos, _ = topk.warp_select_plain(cand.reshape(b, -1), k, vec, cap=4 * select.warp_slots(k))
            gid = torch.from_numpy(block_ids).gather(1, pos // LANES) * LANES + pos % LANES
            assert _same_bits(v, v0) and torch.equal(gid, gid0), (k, vec)
        if k in (2, 5, 8):  # the JAX K4's interpreter compiles each k (about 0.7 s)
            jv, ji = jax_fused(jnp.asarray(np.where(np.isneginf(sb), MASKED, sb)), jnp.asarray(block_ids, jnp.int32),
                               k, interpret=True)
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(gid.numpy(), np.asarray(ji))
    assert [select.warp_slots(k) for k in range(1, 9)] == [2, 2, 4, 4, 6, 6, 8, 8]
