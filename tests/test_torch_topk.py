"""K2 (lemon_tpu_torch.ops.topk) against the Pallas kernel it replaces.

The plain PyTorch version is held to ``lemon_tpu.ops.topk.pallas_topk`` in
Pallas interpret mode (k <= 128, that kernel's bound) and to
``jax.lax.top_k`` (every k, as the JAX package's search falls back to it
above 128): values and indices must be equal exactly, including the tie
rule (lower column first) and rows with fewer than k finite entries. The CUDA kernel itself runs only on the card
(marked ``cuda``). -0.0 and +0.0 tie (the TPU kernel's rule): there
``lax.top_k``, which orders +0.0 before -0.0, agrees on the values only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.ops.topk import pallas_topk
from lemon_tpu_torch.ops import topk as topk_mod

CASES = [
    # (B, W, k): k=1, k=128, W not a multiple of 128, the main path's k*128,
    # k above the TPU kernel's 128 (the JAX package takes lax.top_k there)
    (9, 640, 5),
    (6, 999, 1),
    (5, 300, 128),
    (4, 6528, 51),
    (5, 1000, 200),
    (3, 257, 257),
    # the main path at --knn_k 5: the block maxima of a 16000-row tile
    # (W = T/128) and the (k+1)*128 candidates, both at k+1
    (6, 125, 6),
    (6, 768, 6),
]
SIGNED_ZERO_CASES = [(5, 125, 6), (4, 768, 40)]


def _inputs(b, w, seed, signed_zeros=False):
    """Quantised values (many exact ties), one all -inf row, one row with
    fewer finite entries than any k here, one with a -inf prefix. With
    ``signed_zeros``, values in {-0.5, -0.0, +0.0}, and a row whose only
    zeros lead it with alternating signs."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 12, (b, w)).astype(np.float32) / 4
    if signed_zeros:
        x = rng.choice(np.array([-0.5, -0.0, 0.0], np.float32), (b, w))
        x[3] = -0.5
        x[3, :4] = [-0.0, 0.0, -0.0, 0.0]
    x[0] = -np.inf
    x[1, 1:] = -np.inf
    x[2, :37] = -np.inf
    return x


@pytest.mark.parametrize("case", CASES + [(*c, "signed_zeros") for c in SIGNED_ZERO_CASES])
def test_plain_matches_pallas_and_lax(case):
    b, w, k = case[:3]
    signed_zeros = len(case) == 4
    x = _inputs(b, w, seed=w + k, signed_zeros=signed_zeros)
    v, i = topk_mod.topk(torch.from_numpy(x), k)
    v, i = v.numpy(), i.numpy()
    rv, ri = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(v, np.asarray(rv))
    if signed_zeros:
        assert (v == 0).any() and not np.array_equal(i, np.asarray(ri))  # lax puts +0.0 first
        assert i[3, :4].tolist() == [0, 1, 2, 3] and np.signbit(v[3, [0, 2]]).all()
    else:
        np.testing.assert_array_equal(i, np.asarray(ri))
    if k <= 128:  # the TPU kernel's bound: the JAX package takes lax.top_k above it
        pv, pi = pallas_topk(jnp.asarray(x), k)
        np.testing.assert_array_equal(v, np.asarray(pv))
        np.testing.assert_array_equal(i, np.asarray(pi))


def test_tie_rule_and_neg_inf_order():
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf, 0.5]])
    v, i = topk_mod.topk(x, 7)
    assert i.tolist() == [[1, 2, 4, 0, 6, 3, 5]]
    assert v[0, :5].tolist() == [3.0, 3.0, 3.0, 1.0, 0.5] and torch.isneginf(v[0, 5:]).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        topk_mod.topk(torch.zeros(2, 300), 301)  # k > W: no bound at 128 any more
    with pytest.raises(ValueError):
        topk_mod.topk(torch.zeros(2, 4), 5)  # k > W
    with pytest.raises(ValueError):
        topk_mod.topk(torch.zeros(2, 4), 0)
    with pytest.raises(ValueError):
        topk_mod.topk(torch.zeros(2, 8, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        topk_mod.topk(torch.zeros(8, 2).T, 2)
    with pytest.raises(ValueError):
        topk_mod.topk(torch.zeros(2, 1025), 2, variant="warp")  # the warp variant holds W <= 1024
    with pytest.raises(ValueError):
        topk_mod.topk(torch.zeros(2, 8), 2, variant="bitonic")


def test_cpu_tensors_launch_nothing():
    before = topk_mod.topk.launches
    topk_mod.topk(torch.zeros(3, 10), 2)
    assert topk_mod.topk.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


CARD_CASES = CASES + [(3, 60000, 51), (8192, 1024, 200), (4, 40000, 129), (8192, 125, 6), (8192, 768, 6),
                      (3, 5000, 4500), (40, 1000, 32)]
# more rows checked inside a case's item: W in 129-256 (the warp variant's
# CAP 8) and rows of at most 128 at k <= 8 (8 lanes a row), each at a width
# that is a multiple of 4 and one that is not
MORE_CARD_ROWS = {(6, 125, 6): [(37, 200, 6), (37, 256, 40), (37, 93, 8), (37, 128, 1), (37, 256, 256)]}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["auto", "warp", "radix"])
@pytest.mark.parametrize("case", CARD_CASES + [(*c, "signed_zeros") for c in SIGNED_ZERO_CASES])
def test_kernel_matches_plain_on_the_card(cuda_device, case, variant):
    if variant == "warp" and case[1] > topk_mod.WARP_MAX_W:
        pytest.skip("the warp variant holds rows of at most 1024")
    for b, w, k in [case[:3]] + MORE_CARD_ROWS.get(case, []):
        x = torch.from_numpy(_inputs(b, w, seed=w + k, signed_zeros=len(case) == 4)).to(cuda_device)
        v, i = topk_mod.topk(x, k, variant)
        v0, i0 = topk_mod.topk_plain(x, k)
        torch.cuda.synchronize()
        assert torch.equal(v, v0) and torch.equal(i, i0), (b, w, k, variant)
        assert torch.equal(torch.signbit(v), torch.signbit(v0))
