"""K4 (lemon_tpu_torch.ops.select) against the Pallas kernel it replaces.

``fused_gather_topk_plain`` is held to ``lemon_tpu.ops.select.fused_gather_topk``
in Pallas interpret mode on the same numpy scores and block ids. The JAX
input carries the finite ``MASKED`` sentinel where the port's carries
``-inf`` (the port's K1 writes ``-inf``); both return ``-inf`` there. Values
and ids must be equal exactly, including ties (lower global column first),
rows with fewer finite candidates than k, and B not a multiple of the TPU
kernel's 8-row blocks. The CUDA kernel runs only on the card (marked
``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.ops.scoremax import MASKED
from lemon_tpu.ops.select import fused_gather_topk as jax_fused
from lemon_tpu_torch.knn.index import _blockmax_select
from lemon_tpu_torch.ops import select, topk


def _inputs(b, nb, k, seed):
    """(scores (B, nb, 128) with -inf, block ids (B, k) sorted): quantised
    values (many exact ties), a masked tail, one all-masked row, one row
    whose only finite entries are 3 columns of one block."""
    rng = np.random.default_rng(seed)
    sb = (rng.integers(0, 12, (b, nb * 128)) / 4).astype(np.float32)
    sb[:, -200:] = -np.inf
    sb[0] = -np.inf
    sb[1, :] = -np.inf
    sb[1, 130:133] = 2.0
    sb = sb.reshape(b, nb, 128)
    bmax = sb.max(axis=2)
    ids = np.sort(np.argsort(-bmax, axis=1, kind="stable")[:, :k], axis=1)
    return sb, ids.astype(np.int64)


@pytest.mark.parametrize("k", [1, 5, 51])
def test_plain_matches_jax_fused_gather_topk(k):
    b, nb = 13, 64
    sb, ids = _inputs(b, nb, k, seed=k)
    v, i = select.fused_gather_topk(torch.from_numpy(sb), torch.from_numpy(ids), k)
    v, i = v.numpy(), i.numpy()
    jv, ji = jax_fused(jnp.asarray(np.where(np.isneginf(sb), MASKED, sb)), jnp.asarray(ids, jnp.int32), k, interpret=True)
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(i, np.asarray(ji))
    # an all-masked row takes its first k columns, in order
    assert np.isneginf(v[0]).all() and (i[0] == np.arange(k)).all()
    assert v.shape == (b, k) and i.dtype == np.int64


def test_plain_is_the_search_select_tail():
    """K4 computes what ExactKnnIndex's unfused select tail computes
    (block top-k by K2, sorted, gathered, K2 again)."""
    b, nb, k = 6, 32, 7
    sb, _ = _inputs(b, nb, k, seed=3)
    s = torch.from_numpy(sb.reshape(b, -1))
    bmax = s.view(b, nb, 128).amax(2)
    vals, cols = _blockmax_select(s, bmax, k)
    ids = topk.topk(bmax, k)[1].sort(dim=1).values
    v, i = select.fused_gather_topk(s.view(b, nb, 128), ids, k)
    assert torch.equal(v, vals) and torch.equal(i, cols)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    sb, ids = torch.zeros(2, 4, 128), torch.zeros(2, 3, dtype=torch.int64)
    with pytest.raises(ValueError):
        select.fused_gather_topk(sb, ids, 5)  # k > n_blocks
    with pytest.raises(ValueError):
        select.fused_gather_topk(torch.zeros(2, 200, 128), torch.zeros(2, 129, dtype=torch.int64), 129)  # k > 128
    with pytest.raises(ValueError):
        select.fused_gather_topk(sb, ids.int(), 3)
    with pytest.raises(ValueError):
        select.fused_gather_topk(torch.zeros(2, 4, 64), ids, 3)
    with pytest.raises(ValueError):
        select.fused_gather_topk(sb, torch.zeros(2, 2, dtype=torch.int64), 3)


def test_cpu_tensors_launch_nothing():
    before = select.fused_gather_topk.launches
    sb, ids = _inputs(3, 8, 2, seed=0)
    select.fused_gather_topk(torch.from_numpy(sb), torch.from_numpy(ids), 2)
    assert select.fused_gather_topk.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _misaligned(x):
    """The same values 4 bytes past a 16-byte boundary (scalar loads)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(13, 64, 1), (13, 64, 5), (9, 64, 51), (3, 130, 128), (2048, 1024, 51),
                                  (17, 64, 3), (13, 64, 8), (13, 64, 9), (2048, 1024, 5)])  # warp path k <= 8
def test_kernel_matches_plain_on_the_card(cuda_device, case):
    """Each case aligned and 4 bytes past (at k <= 8 the warp path's 16-byte
    and scalar loads), and at k <= 8 the k one above it too: every instance
    of the warp path (2, 4, 6 and 8 block slots)."""
    b, nb, k0 = case
    for k in (k0, k0 + 1) if k0 < 8 else (k0,):
        sb, ids = (torch.from_numpy(a).to(cuda_device) for a in _inputs(b, nb, k, seed=k))
        sb[2, :, ::3] = -0.0
        v0, i0 = select.fused_gather_topk_plain(sb, ids, k)
        for sv in (sb, _misaligned(sb)):
            before = select.fused_gather_topk.launches
            v, i = select.fused_gather_topk(sv, ids, k)
            assert select.fused_gather_topk.launches == before + 1
            assert torch.equal(v, v0) and torch.equal(i, i0), (b, nb, k, sv.data_ptr() % 16)
            assert torch.equal(torch.signbit(v), torch.signbit(v0))
