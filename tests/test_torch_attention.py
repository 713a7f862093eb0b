"""K3 (lemon_tpu_torch.ops.attention) and the towers' flash route against
the JAX package.

``flash_attention_plain`` is held to ``lemon_tpu.ops.attention.flash_attention``
in Pallas interpret mode and to ``reference_attention`` on the same numpy
inputs in the (B, L, H, D) layout, at tests/test_attention.py's bar (2e-5,
fp32 with another summation order). The towers under
``attention_impl="flash"`` are held to the JAX towers under ``'pallas'`` on a
narrow ViT-B/16-shaped config with the same weights (``from_flax_params``),
at the towers' bar (1e-4). On bf16 inputs both plain versions (the
upcast reference and the bf16 kernel's split scheme) are held to the JAX
kernel and reference on bf16 inputs within one bf16 ulp. On the CPU the
wrapper takes the plain version;
the CUDA kernel is checked against it on the card (marked ``cuda``). The
JAX towers (flax) are imported inside the tests that use them, so the
``cuda`` tests also collect where only jax is installed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.ops.attention import flash_attention as jax_flash
from lemon_tpu.ops.attention import reference_attention
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel
from lemon_tpu_torch.models.convert import from_flax_params
from lemon_tpu_torch.ops import attention

JAX_IMPL = {"plain": "xla", "flash": "pallas"}
# ViT-B/16 geometry at narrow width: 64 px in 16 px patches (17 tokens),
# text context 40, head dim 64 in both towers
NARROW_B16 = ClipConfig(
    embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128, vision_patch_size=16,
    context_length=40, text_width=128, text_heads=2, text_layers=2,
)


def _qkv(b, l, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [33, 50, 77, 128, 200])
def test_plain_matches_jax_flash_and_reference(l, causal):
    q, k, v = _qkv(2, l, 2, 64, seed=l)
    ours = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    assert ours.shape == (2, l, 2, 64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(ours, np.asarray(jax_flash(jq, jk, jv, causal=causal, interpret=True)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ours, np.asarray(reference_attention(jq, jk, jv, causal=causal)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", attention.HEAD_DIMS)
@pytest.mark.parametrize("l", [33, 50, 77, 128, 200])
def test_3xtf32_scheme_matches_jax_reference(l, d, causal):
    """The kernel's precision scheme (TF32 hi/lo splits, three products in
    fp32) meets the 2e-5 bar against the JAX reference, before any card."""
    q, k, v = _qkv(2, l, 2, d, seed=100 + l)
    ours = attention.flash_attention_3xtf32_plain(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    assert ours.shape == (2, l, 2, d)
    ref = np.asarray(reference_attention(*map(jnp.asarray, (q, k, v)), causal=causal))
    np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=2e-5)


def test_split_tf32_plain_is_the_kernels_split():
    tie = 1 + 2**-11  # halfway between two TF32 values
    x = torch.tensor([1.0, tie + 2**-20, tie - 2**-20, -(tie + 2**-20), 3.0 * 2**-130, 0.0], dtype=torch.float32)
    hi, lo = attention.split_tf32_plain(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all() and (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert hi.tolist()[:4] == [1.0, 1 + 2**-10, 1.0, -(1 + 2**-10)]  # to nearest
    rng = np.random.default_rng(0)
    y = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32))
    hi, lo = attention.split_tf32_plain(y)
    assert ((y - hi).abs() <= y.abs() * 2.0**-11).all()
    assert ((y - hi - lo).abs() <= y.abs() * 2.0**-22).all()


def _bf16_qkv(b, l, h, d, seed):
    """bf16 q, k, v as torch tensors and as numpy fp32 holding the same values."""
    ts = [torch.from_numpy(x).bfloat16() for x in _qkv(b, l, h, d, seed)]
    return ts, [t.float().numpy() for t in ts]


def _one_bf16_ulp(ref: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each element of ``ref`` (8 significant bits), taken at
    no less than 2^-8 of the tensor's largest magnitude: closer to zero the
    two fp32 computations' own rounding (~1e-7 absolute) is more than one
    ulp of the element."""
    mag = np.maximum(np.abs(ref), np.abs(ref).max() * 2.0**-8)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _within_one_ulp(out, ref) -> bool:
    out, ref = (np.asarray(x, np.float32) for x in (out, ref))
    return bool((np.abs(out - ref) <= _one_bf16_ulp(ref)).all())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [33, 77])
def test_bf16_plains_match_jax_within_one_ulp(l, d, causal):
    """The JAX kernel upcasts bf16 q, k, v, accumulates in fp32 and writes
    bf16 (lemon_tpu/ops/attention.py:42, 48-49, 144): the port's plain
    version and the bf16 kernel's scheme (S of the bf16 values in fp32, P
    split into bf16 hi + lo) both land within one bf16 ulp of it."""
    (q, k, v), arrays = _bf16_qkv(2, l, 2, d, seed=200 + l + d)
    ours = attention.flash_attention(q, k, v, causal=causal)
    emu = attention.flash_attention_bf16_plain(q, k, v, causal=causal)
    assert ours.dtype == emu.dtype == torch.bfloat16 and ours.shape == (2, l, 2, d)
    assert torch.equal(ours, attention.flash_attention_plain(q, k, v, causal=causal))  # the CPU takes the plain version
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in arrays)
    for ref in (jax_flash(jq, jk, jv, causal=causal, interpret=True), reference_attention(jq, jk, jv, causal=causal)):
        assert ref.dtype == jnp.bfloat16
        for out in (ours, emu):
            assert _within_one_ulp(out.float().numpy(), np.asarray(ref, np.float32))


def test_bf16_split_scheme_is_closer_than_one_bf16_product():
    """Why P . V takes two bf16 products: P rounded to bf16 alone misses the
    one-ulp bar that the split meets."""
    (q, k, v), _ = _bf16_qkv(2, 197, 4, 64, seed=7)
    ref = attention.flash_attention_plain(q, k, v).float().numpy()
    assert _within_one_ulp(attention.flash_attention_bf16_plain(q, k, v).float().numpy(), ref)
    qf, kf, vf = (x.float() for x in (q, k, v))
    p = torch.softmax(torch.einsum("blhd,bmhd->bhlm", qf, kf) * 64**-0.5, dim=-1)
    single = torch.einsum("bhlm,bmhd->blhd", p.bfloat16().float(), vf).bfloat16().float().numpy()
    assert not _within_one_ulp(single, ref)


def _jax_cfg(cfg: ClipConfig):
    from lemon_tpu.models import clip as jclip

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["attention_impl"] = JAX_IMPL[cfg.attention_impl]
    return jclip.ClipConfig(**fields)


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = np.zeros((b, cfg.context_length), np.int32)
    for r in range(b):  # SOT, a few ids, EOT (the max id), zero padding
        n = 5 + 7 * r
        tokens[r, 0] = cfg.vocab_size - 2
        tokens[r, 1 : n + 1] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[r, n + 1] = cfg.vocab_size - 1
    return pixels, tokens


def _port_embed(state, cfg, pixels, tokens):
    model = ClipModel(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        return (model.eval().encode_image(torch.from_numpy(pixels)).numpy(),
                model.encode_text(torch.from_numpy(tokens).long()).numpy())


def test_towers_under_flash_match_jax_pallas():
    from lemon_tpu.models import clip as jclip

    cfg = dataclasses.replace(NARROW_B16, attention_impl="flash")
    jcfg = _jax_cfg(cfg)
    _, params = jclip.init_params(jcfg, seed=2)
    pixels, tokens = _inputs(cfg, 3, seed=1)
    img, txt = _port_embed(from_flax_params(params), cfg, pixels, tokens)
    jmodel = jclip.ClipModel(jcfg)  # 'pallas' runs the kernel in interpret mode on the CPU
    np.testing.assert_allclose(img, np.asarray(jmodel.apply(params, jnp.asarray(pixels), method="encode_image")), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(txt, np.asarray(jmodel.apply(params, jnp.asarray(tokens), method="encode_text")), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg", [ClipConfig.tiny(), NARROW_B16], ids=["tiny", "narrow_b16"])
def test_flash_and_plain_routes_agree(cfg):
    """One state dict under both routes of the port (the comparison
    chip_smoke makes at full width on the card)."""
    from lemon_tpu.models import clip as jclip

    _, params = jclip.init_params(_jax_cfg(cfg), seed=4)
    state = from_flax_params(params)
    pixels, tokens = _inputs(cfg, 2, seed=3)
    plain = _port_embed(state, cfg, pixels, tokens)
    flash = _port_embed(state, dataclasses.replace(cfg, attention_impl="flash"), pixels, tokens)
    for a, b in zip(plain, flash):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 5, 2, 64)
    with pytest.raises(ValueError, match="forward only"):
        attention.flash_attention(q.clone().requires_grad_(True), q, q)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(*(torch.zeros(2, 5, 2, 48),) * 3)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, torch.zeros(2, 6, 2, 64))  # shapes differ
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q.double())
    with pytest.raises(ValueError):
        attention.flash_attention(*(torch.zeros(2, 0, 2, 64),) * 3)
    with pytest.raises(ValueError, match="attention_impl"):
        ClipConfig(attention_impl="pallas")


def test_cpu_tensors_launch_nothing():
    before = attention.flash_attention.launches
    q, k, v = map(torch.from_numpy, _qkv(1, 9, 1, 32, seed=0))
    out = attention.flash_attention(q, k, v, causal=True)
    assert attention.flash_attention.launches == before
    assert torch.equal(out, attention.flash_attention_plain(q, k, v, causal=True))
    # the first query sees only itself
    assert torch.allclose(out[:, 0], v[:, 0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # the towers' shapes (ViT-B/16 vision, ctx-256 text, ViT-B/32 vision, ctx-77 text), then odd ones
    (128, 197, 12, 64, False), (128, 256, 8, 64, True), (128, 50, 12, 64, False), (128, 77, 8, 64, True),
    (3, 33, 2, 32, True), (2, 200, 3, 128, False), (4, 1, 1, 64, True),
    (2, 197, 24, 32, False), (2, 256, 4, 128, True), (3, 70, 2, 128, True), (2, 130, 1, 32, True),
])
def test_kernel_matches_plain_on_the_card(cuda_device, shape):
    b, l, h, d, causal = shape
    g = torch.Generator(device=cuda_device).manual_seed(l)
    x = torch.randn(b, l, 3 * h * d, device=cuda_device, generator=g)
    q, k, v = (t.reshape(b, l, h, d) for t in x.split(h * d, dim=-1))  # strided, as in the towers
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v, causal)
    assert attention.flash_attention.launches == before + 1
    ref = attention.flash_attention_plain(q, k, v, causal)
    assert (out - ref).abs().max().item() <= 2e-5
    assert (out - attention.flash_attention_3xtf32_plain(q, k, v, causal)).abs().max().item() <= 2e-5
    assert torch.equal(out, attention.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # the towers' shapes, then odd ones and the other head dims
    (128, 197, 12, 64, False), (128, 256, 8, 64, True), (128, 50, 12, 64, False), (128, 77, 8, 64, True),
    (3, 33, 2, 32, True), (2, 200, 3, 128, False), (4, 1, 1, 64, True), (2, 197, 24, 32, False),
    (2, 256, 4, 128, True), (3, 70, 2, 128, True), (2, 130, 1, 32, True),
    # more items than the persistent grid has blocks; causal items past the
    # first key tile; L = 1 at the other head dims; unmasked last key tiles of
    # 48 and 32 keys
    (300, 197, 12, 64, False), (5, 100, 3, 64, True), (3, 1, 2, 32, False), (2, 1, 2, 128, True),
    (2, 100, 2, 64, False), (3, 90, 2, 128, False),
])
def test_bf16_kernel_within_one_ulp_on_the_card(cuda_device, shape):
    b, l, h, d, causal = shape
    g = torch.Generator(device=cuda_device).manual_seed(l)
    x = torch.randn(b, l, 3 * h * d, device=cuda_device, generator=g).bfloat16()
    q, k, v = (t.reshape(b, l, h, d) for t in x.split(h * d, dim=-1))  # strided, as in the towers
    before, before_bf16 = attention.flash_attention.launches, attention.flash_attention.launches_bf16
    out = attention.flash_attention(q, k, v, causal)
    assert attention.flash_attention.launches == before + 1
    assert attention.flash_attention.launches_bf16 == before_bf16 + 1
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    for ref in (attention.flash_attention_plain(q, k, v, causal), attention.flash_attention_bf16_plain(q, k, v, causal)):
        assert _within_one_ulp(out.float().cpu().numpy(), ref.float().cpu().numpy())
    assert torch.equal(out, attention.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal))
