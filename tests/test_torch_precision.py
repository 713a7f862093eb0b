"""The port's precision modes (lemon_tpu_torch.core.precision and the bf16,
int8 and int8_static towers of lemon_tpu_torch.models.clip) against the JAX
package.

Both packages hold the same weights: a JAX ``init_params`` tree (and, for
the int8 modes, JAX's quantised and calibrated tree) goes through
``from_flax_params``. Bars, each with its reason:

- the quantised weights and scales: bit for bit (the same fp32 arithmetic);
- ``QuantLinear`` against ``QuantDense(dtype=float32)``: rtol and atol 1e-5,
  tests/test_int8.py:32's bar (exact int32 sums, fp32 epilogue);
- the towers against the JAX towers in the same mode: per-row cosine at
  least 0.9999 in bf16 and 0.9995 in the int8 modes (measured 0.99994 and
  0.99985 at worst on these inputs: bf16 rounds at other places in the two
  frameworks, and in the int8 modes a bf16 difference can flip an int8
  rounding of an activation);
- each mode against its own package's fp32 towers: the JAX package's bars,
  0.98 for int8 and 0.97 for int8_static (tests/test_int8.py:61, :241), and
  0.999 for bf16.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lemon_tpu.core import precision as jprecision
from lemon_tpu.models import clip as jclip
from lemon_tpu.ops.image import preprocess_device as jax_preprocess
from lemon_tpu_torch.core.precision import Precision, default_precision
from lemon_tpu_torch.models import clip as tclip
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel, QuantLinear, init_weights
from lemon_tpu_torch.models.convert import from_flax_params
from lemon_tpu_torch.ops.image import CLIP_STD, preprocess_device

REPO = Path(__file__).resolve().parents[1]
MODES = ("bf16", "int8", "int8_static")
# port vs JAX in the same mode, and each mode vs its own package's fp32
CROSS_BAR = {"bf16": 0.9999, "int8": 0.9995, "int8_static": 0.9995}
FP32_BAR = {"bf16": 0.999, "int8": 0.98, "int8_static": 0.97}
JAX_IMPL = {"plain": "xla", "flash": "pallas"}
# ViT-B/16 geometry at narrow width (17 vision tokens, head dim 64 in both towers)
NARROW_B16 = ClipConfig(
    embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128, vision_patch_size=16,
    context_length=40, text_width=128, text_heads=2, text_layers=2,
)
CONFIGS = {"tiny": ClipConfig.tiny(), "narrow_b16": NARROW_B16}


def _jax_cfg(cfg: ClipConfig) -> jclip.ClipConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["attention_impl"] = JAX_IMPL[cfg.attention_impl]
    return jclip.ClipConfig(**fields)


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = np.zeros((b, cfg.context_length), np.int32)
    for r in range(b):  # SOT, a few ids, EOT (the max id), zero padding
        n = 2 + (3 * r) % (cfg.context_length - 3)
        tokens[r, 0] = cfg.vocab_size - 2
        tokens[r, 1 : n + 1] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[r, n + 1] = cfg.vocab_size - 1
    return pixels, tokens


def _min_cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return float((a * b).sum(1).min())


def _port_embed(model, pixels, tokens):
    with torch.no_grad():
        return (model.eval().encode_image(torch.from_numpy(pixels)).numpy(),
                model.encode_text(torch.from_numpy(tokens).long()).numpy())


def _jax_tree(jmodel, params, mode, pixels):
    """The tree the JAX encoder would run in ``mode``: quantised, and
    calibrated on ``pixels`` under int8_static."""
    if mode == "bf16":
        return params
    tree = jclip.quantize_clip_params(params, static_act=mode == "int8_static")
    if mode == "int8_static":
        tree = jclip.calibrate_act_scales(jmodel, tree, pixels=jnp.asarray(pixels))
    return tree


@pytest.mark.parametrize("value", [None, "fp32", "bf16", "bfloat16", "BF16", "int8", "int8_static", "fp16"])
def test_presets_and_default_precision_match_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("LEMON_TPU_PRECISION", raising=False)
    else:
        monkeypatch.setenv("LEMON_TPU_PRECISION", value)
    ours, theirs = default_precision(), jprecision.default_precision()
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name.endswith("dtype"):
            assert str(a).removeprefix("torch.") == jnp.dtype(b).name, f.name
        else:
            assert a == b, f.name
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]


@pytest.mark.parametrize("static_act", [False, True])
def test_quantized_weights_are_bit_identical_to_jax(static_act):
    _, params = jclip.init_params(_jax_cfg(ClipConfig.tiny()), seed=3)
    jtree = jclip.quantize_clip_params(params, static_act=static_act)
    state = from_flax_params(params)
    ours = tclip.quantize_clip_params(state, static_act=static_act)
    expected = from_flax_params(jtree)  # kernel_q transposed to (out, in), int8 kept
    assert ours.keys() == expected.keys()
    n_quant = 0
    for key, val in expected.items():
        assert ours[key].dtype == val.dtype and torch.equal(ours[key], val), key
        n_quant += key.endswith(".weight_q")
    assert n_quant == 4 * ClipConfig.tiny().vision_layers  # qkv, out, mlp_fc, mlp_proj of each vision block
    assert all(torch.equal(ours[k], state[k]) for k in state if k.startswith("text."))  # the text tower stays float


@pytest.mark.parametrize("static_act,weight_only", [(False, False), (True, False), (False, True), (True, True)])
def test_quant_linear_matches_jax_quant_dense(static_act, weight_only):
    rng = np.random.default_rng(7)
    w = rng.normal(size=(16, 24)).astype(np.float32)  # flax (in, out)
    b = rng.normal(size=24).astype(np.float32)
    x = rng.normal(size=(4, 5, 16)).astype(np.float32)
    q = jclip.quantize_clip_params({"qkv": {"kernel": w, "bias": b}}, static_act=static_act)["qkv"]
    if static_act:
        q = {**q, "act_scale": np.float32(np.abs(x).max() / 127.0)}
    ref = jclip.QuantDense(24, dtype=jnp.float32, static_act=static_act, weight_only=weight_only).apply(
        {"params": q}, jnp.asarray(x))
    layer = QuantLinear(16, 24, torch.float32, static_act=static_act, weight_only=weight_only)
    layer.load_state_dict({
        "weight_q": torch.from_numpy(q["kernel_q"].T.copy()), "weight_scale": torch.from_numpy(q["kernel_scale"]),
        "bias": torch.from_numpy(b), **({"act_scale": torch.tensor(q["act_scale"])} if static_act else {})})
    with torch.no_grad():
        ours = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_calibration_matches_jax_and_the_calibrated_tree_loads():
    cfg = ClipConfig.tiny()
    jcfg = _jax_cfg(cfg)
    jmodel = jclip.ClipModel(jcfg, precision=jprecision.Precision.int8_static())
    _, params = jclip.init_params(jcfg, seed=5)
    pixels, _ = _inputs(cfg, 4, seed=5)
    jtree = _jax_tree(jmodel, params, "int8_static", pixels)

    model = ClipModel(cfg, Precision.int8_static())
    model.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        tclip.calibrate_act_scales(model, pixels=torch.from_numpy(pixels))
    calibrated = from_flax_params(jtree)
    scales = {k: v for k, v in model.state_dict().items() if k.endswith("act_scale")}
    assert len(scales) == 4 * cfg.vision_layers
    for key, val in scales.items():
        assert val.item() != 1.0, key
        if key == "visual.blocks.0.attn.qkv.act_scale":
            # its input passed no quantised layer: equal up to bf16 rounding
            np.testing.assert_allclose(val.item(), calibrated[key].item(), rtol=2**-7, err_msg=key)
        else:
            # as in JAX, the calibrating forward runs the layers before it
            # with the placeholder scale 1 (integer-rounded activations), so
            # a bf16 difference flips roundings there: measured within 15%
            # (JAX's own robustness bar is a factor of 4, tests/test_int8.py:337)
            assert 0.8 < val.item() / calibrated[key].item() < 1.25, key
    loaded = ClipModel(cfg, Precision.int8_static())
    loaded.load_state_dict(calibrated)
    for key, val in loaded.state_dict().items():
        assert torch.equal(val, calibrated[key].to(val.dtype)), key


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_towers_match_jax_in_each_mode(name, mode, impl):
    cfg = dataclasses.replace(CONFIGS[name], attention_impl=impl)
    jcfg = _jax_cfg(cfg)
    _, params = jclip.init_params(jcfg, seed=1)
    pixels, tokens = _inputs(cfg, 4, seed=2)
    jmodel = jclip.ClipModel(jcfg, precision=getattr(jprecision.Precision, mode)())
    jtree = _jax_tree(jmodel, params, mode, pixels)
    j_img = np.asarray(jmodel.apply(jtree, jnp.asarray(pixels), method="encode_image"))
    j_txt = np.asarray(jmodel.apply(jtree, jnp.asarray(tokens), method="encode_text"))

    model = ClipModel(cfg, getattr(Precision, mode)())
    model.load_state_dict(from_flax_params(jtree))
    img, txt = _port_embed(model, pixels, tokens)
    assert img.dtype == txt.dtype == np.float32 and img.shape == txt.shape == (4, cfg.embed_dim)
    assert _min_cos(img, j_img) >= CROSS_BAR[mode] and _min_cos(txt, j_txt) >= CROSS_BAR[mode]

    # each package against its own fp32 towers
    fp32 = ClipModel(cfg)
    fp32.load_state_dict(from_flax_params(params))
    f_img, f_txt = _port_embed(fp32, pixels, tokens)
    jf = jclip.ClipModel(jcfg)
    jf_img = np.asarray(jf.apply(params, jnp.asarray(pixels), method="encode_image"))
    for ours, ref in ((img, f_img), (txt, f_txt), (j_img, jf_img)):
        assert _min_cos(ours, ref) > FP32_BAR[mode]


def test_bf16_model_holds_bf16_projections_of_the_same_weights():
    """One seed gives every mode the same weights (through the fp32 twin);
    the projections are cast once, LayerNorm and embeddings stay fp32."""
    cfg = ClipConfig.tiny()
    fp32 = init_weights(ClipModel(cfg), seed=4).state_dict()
    bf16 = init_weights(ClipModel(cfg, Precision.bf16()), seed=4).state_dict()
    assert fp32.keys() == bf16.keys()
    for key, val in bf16.items():
        proj = key.endswith(("qkv.weight", "out.weight", "mlp_fc.weight", "mlp_proj.weight", "patch_embed.weight",
                             "proj", "text_projection", "qkv.bias", "out.bias", "mlp_fc.bias", "mlp_proj.bias"))
        assert val.dtype == (torch.bfloat16 if proj else torch.float32), key
        assert torch.equal(val, fp32[key].to(val.dtype)), key
    int8 = init_weights(ClipModel(cfg, Precision.int8()), seed=4).state_dict()
    assert torch.equal(int8["visual.blocks.0.mlp_fc.weight_q"], tclip.quantize_clip_params(fp32)["visual.blocks.0.mlp_fc.weight_q"])


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_pooled_last_block_matches_the_full_block(mode):
    """The pooled last block computes the CLS (and, with
    pool_last_block_text, the first-EOT) row alone: the same math per row.
    fp32 at tests/test_clip_parity.py:251's 1e-5; bf16 within its rounding."""
    cfg = dataclasses.replace(ClipConfig.tiny(), pool_last_block_text=True)
    base = getattr(Precision, mode)()
    pooled = init_weights(ClipModel(cfg, dataclasses.replace(base, pool_last_block=True)), seed=6)
    full = ClipModel(cfg, dataclasses.replace(base, pool_last_block=False))
    full.load_state_dict(pooled.state_dict())
    assert pooled.visual.pooled and pooled.text.pooled and not full.visual.pooled
    pixels, tokens = _inputs(cfg, 5, seed=6)
    for a, b in zip(_port_embed(pooled, pixels, tokens), _port_embed(full, pixels, tokens)):
        if mode == "fp32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert _min_cos(a, b) >= 0.9999
    flash = ClipModel(dataclasses.replace(cfg, attention_impl="flash"), dataclasses.replace(base, pool_last_block=True))
    assert not flash.visual.pooled and not flash.text.pooled  # never under flash


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_ln_folded_dense_matches_jax(compute):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 2 + 0.5
    kernel = rng.normal(size=(16, 24)).astype(np.float32)
    bias, g, beta = (rng.normal(size=n).astype(np.float32) for n in (24, 16, 16))
    ref = jclip.ln_folded_dense(*map(jnp.asarray, (x, kernel, bias, g, beta)), compute_dtype=jnp.dtype(compute))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ours = tclip.ln_folded_dense(t(x), t(kernel.T), t(bias), t(g), t(beta), compute_dtype=getattr(torch, compute))
    assert ours.dtype == getattr(torch, compute)
    tol = 1e-5 if compute == "float32" else 2**-7  # bf16: the result's own rounding
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_fold_ln_towers_match_jax():
    """Precision.fold_ln (no preset sets it) is honoured, not ignored."""
    cfg = ClipConfig.tiny()
    prec = dataclasses.replace(Precision.bf16(), fold_ln=True)
    jprec = dataclasses.replace(jprecision.Precision.bf16(), fold_ln=True)
    jmodel, params = jclip.init_params(_jax_cfg(cfg), seed=9, precision=jprec)
    model = ClipModel(cfg, prec)
    model.load_state_dict(from_flax_params(params))
    assert model.visual.blocks[0].attn.qkv.weight.dtype == torch.float32  # folded per call, as JAX does
    pixels, tokens = _inputs(cfg, 4, seed=9)
    img, txt = _port_embed(model, pixels, tokens)
    assert _min_cos(img, jmodel.apply(params, jnp.asarray(pixels), method="encode_image")) >= 0.9999
    assert _min_cos(txt, jmodel.apply(params, jnp.asarray(tokens), method="encode_text")) >= 0.9999
    with pytest.raises(ValueError, match="mutually exclusive"):
        ClipModel(cfg, dataclasses.replace(Precision.int8(), fold_ln=True))


@pytest.mark.parametrize("h,w", [(32, 32), (480, 640), (96, 128)])
def test_fast_preprocess_matches_jax(h, w):
    """``pil_rounding=False, precision="default"``: the TPU's one bf16 pass.
    On XLA:CPU the JAX ``DEFAULT`` is plain fp32, so against it the port's
    bf16 operand rounding shows: the resize weights to 2^-9 (about 0.6 of
    255 a pass, their absolute sum being up to 1.2) and the first pass's
    intermediate to half a bf16 ulp (1 at values of 256 and up), at most
    about 2.5 of 255 after both passes, 0.04 of the normalised range. Without the bf16 rounding
    (``precision="highest"``) the two agree to fp32 rounding."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    cpu = torch.device("cpu")
    fast = preprocess_device(img, 224, cpu, pil_rounding=False, precision="default").numpy()
    exact = preprocess_device(img, 224, cpu, pil_rounding=False, precision="highest").numpy()
    jax_fast = np.asarray(jax_preprocess(img, 224, pil_rounding=False, precision="default"))
    np.testing.assert_allclose(exact, jax_fast, rtol=0, atol=2e-5)
    assert np.abs(fast - jax_fast).max() < 0.04
    assert np.abs(fast - jax_fast).max() > 0  # the bf16 rounding took place
    with pytest.raises(ValueError, match="precision"):
        preprocess_device(img, 224, cpu, precision="medium")


@pytest.mark.parametrize("h,w", [(32, 32), (480, 640), (96, 128)])
def test_high_preprocess_within_one_uint8_level(h, w):
    """``precision="high"``: each resize pass as K1 'high''s three bf16
    products (hi.hi + (hi.lo + lo.hi), fp32 sums). XLA:CPU computes JAX's
    HIGH as plain fp32, so the port is held to it, and to its own
    'highest', within one uint8 level after normalisation (1/255/std: the
    bf16x3 error can flip a PIL rounding between the passes), with at most
    0.1% of the values differing."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    cpu = torch.device("cpu")
    high = preprocess_device(img, 224, cpu, precision="high").numpy()
    level = 1 / 255 / np.asarray(CLIP_STD, np.float32) + 1e-5
    for ref in (np.asarray(jax_preprocess(img, 224, precision="high")),
                preprocess_device(img, 224, cpu, precision="highest").numpy()):
        diff = np.abs(high - ref)
        assert (diff <= level).all(), diff.max()
        assert (diff > 1e-6).mean() <= 1e-3


def _encoder(mode, batch_size=16):
    from lemon_tpu_torch.models.encoder import ClipEncoder

    model = init_weights(ClipModel(ClipConfig.tiny(), getattr(Precision, mode)()), seed=0)
    return ClipEncoder(model, torch.device("cpu"), batch_size=batch_size, weights_fingerprint="random:0")


def test_int8_static_encoder_calibrates_lazily():
    from lemon_tpu_torch.data.datasets import synthetic_captioning

    split = synthetic_captioning(60, data_seed=0)[0]  # 48 rows: 3 batches
    texts = list(split.sentence)
    enc = _encoder("int8_static")
    scales = lambda e: [m.act_scale.item() for m in e.model.modules() if isinstance(m, QuantLinear)]  # noqa: E731
    assert not enc._calibrated and all(s == 1.0 for s in scales(enc))
    img = enc.encode_images(split.images)
    assert enc._calibrated and all(s != 1.0 for s in scales(enc))
    first = scales(enc)
    np.testing.assert_array_equal(enc.encode_images(split.images), img)  # the scales stay fixed
    assert scales(enc) == first
    txt = enc.encode_texts(texts)
    for emb in (img, txt):
        assert np.isfinite(emb).all()
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    # embed_split calibrates on its own first batch: the same rows
    enc2 = _encoder("int8_static")
    img2, txt2 = enc2.embed_split(split, texts)
    assert enc2._calibrated and scales(enc2) == first
    np.testing.assert_allclose(img2, img, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(txt2, txt, rtol=1e-5, atol=1e-6)


def test_cache_key_folds_in_the_precision():
    """A bf16 or int8 run must never read an fp32 run's --embedding_cache."""
    from lemon_tpu_torch.data.datasets import synthetic_captioning

    split = synthetic_captioning(40, data_seed=0)[0]
    texts = list(split.sentence)
    keys = {mode: _encoder(mode).cache_key(split, texts) for mode in ("fp32", "bf16", "int8", "int8_static")}
    assert len(set(keys.values())) == 4
    assert _encoder("bf16").cache_key(split, texts) == keys["bf16"]


def test_bf16_encoder_takes_the_fast_resize():
    assert _encoder("bf16")._pp_kwargs == {"pil_rounding": False, "precision": "default"}
    assert _encoder("int8")._pp_kwargs == {"pil_rounding": False, "precision": "default"}
    assert _encoder("fp32")._pp_kwargs == {}


@pytest.mark.parametrize("mode", ["bf16", "int8_static"])
def test_cli_runs_in_the_mode_the_environment_names(mode, tmp_path):
    env = {**os.environ, "LEMON_TPU_PRECISION": mode, "PYTHONPATH": str(REPO)}
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "lemon_tpu_torch.cli.run_lemon", "--output_dir", str(out), "--dataset",
         "synthetic_caption", "--noise_type", "random", "--clip_model", "tiny", "--platform", "cpu",
         "--synthetic_n", "200"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (out / "done").exists()
    scores = pd.read_csv(out / "know_val_labels_scores.csv")["pred_score"].to_numpy()
    assert len(scores) == 200 and np.isfinite(scores).all()
    log = (out / "out.txt").read_text()
    assert f"precision: {getattr(Precision, mode)()}" in log
