"""The port's ModifiedResNet tower (``lemon_tpu_torch.models.resnet``, the
``rn50`` family) against the JAX package's, at the ``tiny_rn`` size.

Both packages hold the same weights: one random OpenAI-format RN state dict
(random batch-norm statistics too: a fresh init is at identity, which would
hide a mistake in ``FrozenBatchNorm``) through each package's loader. Bars:
- fp32 towers within 1e-5 (rtol and atol: fp32 with another summation
  order, the convolutions in cuDNN/oneDNN against XLA's);
- bf16 towers per-row cosine at least 0.9999 to the JAX bf16 towers (bf16
  rounds at other places in the two frameworks);
- an OpenAI-format RN state dict through both loaders: the same config and
  bit-equal weights.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.core import precision as jprecision
from lemon_tpu.models import clip as jclip
from lemon_tpu.models import loader as jloader
from lemon_tpu.models import registry as jregistry
from lemon_tpu_torch.core.precision import Precision
from lemon_tpu_torch.models import registry
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel, init_weights
from lemon_tpu_torch.models.convert import from_flax_params
from lemon_tpu_torch.models.loader import detect_and_convert

CFG = ClipConfig.tiny_rn()
# a plain Bottleneck (no projected skip) after layer1's first, and a
# strided one with two blocks in layer3
CFG_2BLOCKS = dataclasses.replace(CFG, vision_layers=(2, 1, 2, 1))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(cfg: ClipConfig) -> jclip.ClipConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["attention_impl"] = "xla"
    return jclip.ClipConfig(**fields)


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = np.zeros((b, cfg.context_length), np.int32)
    for r in range(b):  # SOT, a few ids, EOT (the max id), zero padding
        n = 3 + r
        tokens[r, 0] = cfg.vocab_size - 2
        tokens[r, 1 : n + 1] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[r, n + 1] = cfg.vocab_size - 1
    return pixels, tokens


def _both(cfg, mode, seed=0, b=4):
    """Both packages' towers in ``mode`` on one random OpenAI-format RN
    state dict through each package's loader: (ours, JAX's) embeddings."""
    sd = _rn_openai_state_dict(cfg, seed)
    tree, _ = detect_and_convert(sd)
    jtree, _ = jloader.detect_and_convert(sd)
    # the given config (the shapes alone read one text head where tiny_rn has two)
    model = ClipModel(cfg, getattr(Precision, mode)())
    model.load_state_dict(from_flax_params(tree))
    jmodel = jclip.ClipModel(_jax_cfg(cfg), precision=getattr(jprecision.Precision, mode)())
    pixels, tokens = _inputs(cfg, b, seed + 1)
    with torch.no_grad():
        img = model.eval().encode_image(torch.from_numpy(pixels)).float().numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).float().numpy()
    jimg = np.asarray(jmodel.apply(jtree, jnp.asarray(pixels), method="encode_image"), np.float32)
    jtxt = np.asarray(jmodel.apply(jtree, jnp.asarray(tokens), method="encode_text"), np.float32)
    return (img, txt), (jimg, jtxt)


def _row_cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


@pytest.mark.parametrize("cfg", [CFG, CFG_2BLOCKS], ids=["tiny_rn", "two_blocks"])
def test_towers_match_jax_fp32(cfg):
    (img, txt), (jimg, jtxt) = _both(cfg, "fp32")
    assert img.shape == (4, cfg.embed_dim) and txt.shape == (4, cfg.embed_dim)
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(txt, jtxt, rtol=1e-5, atol=1e-5)


def test_towers_match_jax_bf16():
    (img, txt), (jimg, jtxt) = _both(CFG, "bf16", seed=2, b=6)
    assert _row_cos(img, jimg).min() >= 0.9999, _row_cos(img, jimg)
    assert _row_cos(txt, jtxt).min() >= 0.9999, _row_cos(txt, jtxt)


def test_int8_modes_refuse_the_resnet_tower():
    """The JAX package asserts the same (clip.py:835): int8 covers the ViT."""
    with pytest.raises(ValueError, match="ViT"):
        ClipModel(CFG, Precision.int8())


def _rn_openai_state_dict(cfg: ClipConfig, seed: int) -> dict:
    """A random OpenAI-format ModifiedResNet CLIP state dict
    (chexzero_clip.py layout: visual.conv1-3/bn1-3, visual.layerS.J.*,
    visual.attnpool.*, the text transformer)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape, scale=0.1):
        sd[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def bn(prefix, n):
        sd[f"{prefix}.weight"] = (1 + 0.2 * rng.standard_normal(n)).astype(np.float32)
        put(f"{prefix}.bias", n)
        put(f"{prefix}.running_mean", n)
        sd[f"{prefix}.running_var"] = (0.5 + rng.random(n)).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.array(0, np.int64)

    w = cfg.vision_width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), start=1):
        put(f"visual.conv{i}.weight", cout, cin, 3, 3)
        bn(f"visual.bn{i}", cout)
    cin = w
    for stage, n_blocks in enumerate(cfg.vision_layers, start=1):
        planes = w * 2 ** (stage - 1)
        for j in range(n_blocks):
            p = f"visual.layer{stage}.{j}"
            put(f"{p}.conv1.weight", planes, cin, 1, 1)
            put(f"{p}.conv2.weight", planes, planes, 3, 3)
            put(f"{p}.conv3.weight", planes * 4, planes, 1, 1)
            for c, n in ((1, planes), (2, planes), (3, planes * 4)):
                bn(f"{p}.bn{c}", n)
            if j == 0:
                put(f"{p}.downsample.0.weight", planes * 4, cin, 1, 1)
                bn(f"{p}.downsample.1", planes * 4)
            cin = planes * 4
    spatial = cfg.image_resolution // 32
    put("visual.attnpool.positional_embedding", spatial * spatial + 1, cin)
    for proj, out in (("q_proj", cin), ("k_proj", cin), ("v_proj", cin), ("c_proj", cfg.embed_dim)):
        put(f"visual.attnpool.{proj}.weight", out, cin)
        put(f"visual.attnpool.{proj}.bias", out, scale=0.02)
    tw = cfg.text_width
    put("token_embedding.weight", cfg.vocab_size, tw)
    put("positional_embedding", cfg.context_length, tw)
    for i in range(cfg.text_layers):
        p = f"transformer.resblocks.{i}"
        put(f"{p}.attn.in_proj_weight", 3 * tw, tw)
        put(f"{p}.attn.in_proj_bias", 3 * tw, scale=0.02)
        put(f"{p}.attn.out_proj.weight", tw, tw)
        put(f"{p}.attn.out_proj.bias", tw, scale=0.02)
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = (1 + 0.1 * rng.standard_normal(tw)).astype(np.float32)
            put(f"{p}.{ln}.bias", tw)
        put(f"{p}.mlp.c_fc.weight", 4 * tw, tw)
        put(f"{p}.mlp.c_fc.bias", 4 * tw, scale=0.02)
        put(f"{p}.mlp.c_proj.weight", tw, 4 * tw)
        put(f"{p}.mlp.c_proj.bias", tw, scale=0.02)
    sd["ln_final.weight"] = np.ones(tw, np.float32)
    put("ln_final.bias", tw)
    put("text_projection", tw, cfg.embed_dim)
    sd["logit_scale"] = np.array(np.log(1 / 0.07), np.float32)
    return sd


def _jax_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "attention_impl"}


def test_rn_state_dict_converts_like_the_jax_loader(tmp_path):
    """Both loaders, on the state dict and on a ``.pt`` file through both
    registries: the same config and bit-equal weights."""
    cfg = dataclasses.replace(CFG_2BLOCKS, text_heads=2)
    sd = _rn_openai_state_dict(cfg, seed=5)
    tree, got_cfg = detect_and_convert(sd)
    jtree, jcfg = jloader.detect_and_convert(sd)
    assert got_cfg.is_resnet and got_cfg.vision_layers == (2, 1, 2, 1)
    assert _jax_fields(got_cfg) == {k: getattr(jcfg, k) for k in _jax_fields(got_cfg)}
    ours, theirs = from_flax_params(tree), from_flax_params(jtree)
    assert ours.keys() == theirs.keys() == ClipModel(got_cfg).state_dict().keys()
    for key in ours:
        assert torch.equal(ours[key], theirs[key]), key

    path = tmp_path / "rn.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    state, loaded_cfg = registry.load_checkpoint(path, registry.MODEL_CONFIGS["rn50"])
    assert loaded_cfg == got_cfg
    jparams, _ = jregistry._load_params(path, jregistry.MODEL_CONFIGS["rn50"])
    for key, val in from_flax_params(jparams).items():
        assert torch.equal(state[key], val), key


def test_random_init_is_seeded_and_at_identity_batch_norm():
    a = init_weights(ClipModel(CFG), seed=0).state_dict()
    b = init_weights(ClipModel(CFG), seed=0).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["visual.stem_bn1.weight"].eq(1).all() and a["visual.stem_bn1.running_var"].eq(1).all()
    w = a["visual.layer1_0.conv2.weight"]  # lecun_normal: variance 1 / (in * kh * kw)
    assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1.0) < 0.15
    bf16 = init_weights(ClipModel(CFG, Precision.bf16()), seed=0).state_dict()
    assert torch.equal(bf16["visual.layer1_0.conv2.weight"], w.to(torch.bfloat16))
