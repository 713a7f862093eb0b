"""The port's captioners (``models/captioner.py``, ``qformer.py``, ``blip2.py``)
against the JAX package's, on the CPU.

For each family at ``tiny()`` (LoRA rank 4, B shifted off zero so the
adapters act), a JAX init goes to the port through
``convert.captioner_from_flax``; the same numpy inputs go through both.
Bars: logits and ``per_sample_loss`` within 1e-5 (padding masked); greedy
tokens equal wherever the port's top-2 logit margin exceeds 1e-4 (a
near-tie may break either way); BLIP-2's ``generate_judged`` on left-padded
prompts: tokens so, log-probabilities within 1e-5; the LoRA and
frozen-vision masks select the same parameters as JAX's. ``load_blip2`` on
a tiny HF BLIP-2 (built as tests/test_blip2.py builds it) with
``transformers`` hidden from the port: logits within 1e-5 of HF's.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from captioner_bridge import agree_under_margin, nudge_lora, port_config, port_model

from lemon_tpu.models.blip2 import Blip2Captioner as JaxBlip2, Blip2Config as JaxBlip2Config
from lemon_tpu.models.captioner import CaptionerConfig as JaxCaptionerConfig, CaptioningModel as JaxModel
from lemon_tpu.models.captioner import frozen_vision_mask as jax_frozen_mask
from lemon_tpu.models.captioner import init_captioner as jax_init
from lemon_tpu.models.captioner import lora_trainable_mask as jax_lora_mask
from lemon_tpu.models.qformer import QFormerConfig as JaxQFormerConfig

FAMILIES = {
    "git": lambda: dataclasses.replace(JaxCaptionerConfig.tiny(), lora_rank=4),
    "qformer": lambda: dataclasses.replace(JaxQFormerConfig.tiny(), lora_rank=4),
    "blip2": lambda: dataclasses.replace(JaxBlip2Config.tiny(), lora_rank=4),
}
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    cfg = FAMILIES[request.param]()
    model, params = jax_init(cfg, seed=0)
    params = nudge_lora(params)
    return request.param, cfg, model, params, port_model(params, cfg)


def _inputs(cfg, seed=0, b=3):
    rng = np.random.default_rng(seed)
    r = cfg.vision.image_resolution
    pixels = rng.standard_normal((b, r, r, 3)).astype(np.float32)
    tokens = rng.integers(3, cfg.vocab_size, (b, cfg.max_text_len)).astype(np.int32)
    tokens[:, 0] = cfg.bos_token_id
    tokens[0, 7:] = cfg.pad_token_id  # ragged captions: padding masked in the loss
    tokens[2, 4:] = cfg.pad_token_id
    return pixels, tokens


def test_logits_and_losses_match_jax(family):
    _, cfg, jm, params, pm = family
    pixels, tokens = _inputs(cfg)
    jl = np.asarray(jm.apply(params, jnp.asarray(pixels), jnp.asarray(tokens)))
    jloss = np.asarray(jm.apply(params, jnp.asarray(pixels), jnp.asarray(tokens), method=JaxModel.per_sample_loss))
    with torch.no_grad():
        x, t = torch.from_numpy(pixels), torch.from_numpy(tokens).long()
        pl = pm(x, t).numpy()
        ploss = pm.per_sample_loss(x, t).numpy()
    assert pl.shape == jl.shape == (3, cfg.max_text_len, cfg.vocab_size)
    assert np.abs(pl - jl).max() <= TOL
    assert np.abs(ploss - jloss).max() <= TOL


def _step_margins(pm, pixels, tokens):
    """Top-2 margin of the port's logits at each generated step."""
    with torch.no_grad():
        logits = pm(torch.from_numpy(pixels), torch.from_numpy(tokens).long())[:, :-1]
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def test_greedy_generation_matches_jax(family):
    _, cfg, jm, params, pm = family
    pixels, _ = _inputs(cfg, seed=1)
    bos, eot = cfg.bos_token_id, cfg.eos_token_id if cfg.eos_token_id != cfg.bos_token_id else cfg.vocab_size - 1
    jt = np.asarray(jm.apply(params, jnp.asarray(pixels), bos, eot, method=JaxModel.generate))
    pt = pm.generate(torch.from_numpy(pixels), bos, eot).numpy()
    assert pt.shape == jt.shape == (3, cfg.max_text_len)
    compared = agree_under_margin(jt, pt, _step_margins(pm, pixels, pt))
    assert compared >= (cfg.max_text_len - 1)  # at least one whole row held


def test_temperature_draws_follow_the_generator(family):
    _, cfg, _, _, pm = family
    pixels, _ = _inputs(cfg, seed=2)
    draw = [pm.generate(torch.from_numpy(pixels), cfg.bos_token_id, -1, temperature=1.0,
                        generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])


def test_generate_judged_matches_jax():
    cfg = FAMILIES["blip2"]()
    jm, params = jax_init(cfg, seed=1)
    pm = port_model(params, cfg)
    rng = np.random.default_rng(3)
    pixels = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    prompts = rng.integers(3, cfg.vocab_size, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    prompts[1, :2], mask[1, :2] = cfg.pad_token_id, 0  # left-padded
    jt, jlp = (np.asarray(a) for a in jm.apply(params, jnp.asarray(pixels), jnp.asarray(prompts), jnp.asarray(mask),
                                               max_new_tokens=5, method=JaxBlip2.generate_judged))
    pt, plp = pm.generate_judged(torch.from_numpy(pixels), torch.from_numpy(prompts), torch.from_numpy(mask),
                                 max_new_tokens=5)
    # each step's margin from the port's own judged logits
    with torch.no_grad():
        prefix = pm.encode_image_prefix(torch.from_numpy(pixels))
        text = torch.cat([torch.from_numpy(prompts).long(), pt], dim=1)
        key = torch.cat([torch.from_numpy(mask).long(), torch.ones_like(pt)], dim=1)
        logits = pm._decode(prefix, text, key_mask=key)[:, 5:10]
    top2 = logits.topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).numpy()
    padded = lambda a: np.concatenate([np.zeros((2, 1), a.dtype), a], axis=1)  # noqa: E731
    assert agree_under_margin(padded(jt), padded(pt.numpy()), margins) >= 5
    assert np.abs(plp.numpy() - jlp).max() <= TOL


def test_masks_select_the_same_parameters(family):
    """Each JAX mask, carried through the converter as arrays of 0 or 1,
    names exactly the parameters the port's predicate selects."""
    from lemon_tpu_torch.models.captioner import frozen_vision_mask, lora_trainable_mask
    from lemon_tpu_torch.models.convert import captioner_from_flax

    _, cfg, _, params, pm = family

    def jax_selected(mask):
        as_arrays = jax.tree_util.tree_map(lambda keep, x: np.full(x.shape, float(keep), np.float32), mask, params)
        return sorted(n for n, t in captioner_from_flax(as_arrays, port_config(cfg)).items() if bool(t.all()))

    names = [n for n, _ in pm.named_parameters()]
    for jmask, pmask in ((jax_lora_mask, lora_trainable_mask), (jax_frozen_mask, frozen_vision_mask)):
        assert jax_selected(jmask(params)) == sorted(filter(pmask, names))
    lora = list(filter(lora_trainable_mask, names))
    if hasattr(pm, "lm_head"):
        assert "lm_head.weight" in lora  # JAX's quirk: the head trains under LoRA
    else:
        assert all(n.endswith(("lora_a", "lora_b")) for n in lora)  # BLIP-2: a tied head, the factors only
    assert not any(n.startswith("visual.") for n in filter(frozen_vision_mask, names))


@pytest.fixture(scope="module")
def tiny_hf_blip2(tmp_path_factory):
    from transformers import Blip2Config, Blip2ForConditionalGeneration, Blip2QFormerConfig, Blip2VisionConfig, OPTConfig

    torch.manual_seed(0)
    v = Blip2VisionConfig(hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=2,
                          image_size=56, patch_size=14)
    q = Blip2QFormerConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=48,
                           encoder_hidden_size=32, cross_attention_frequency=2, vocab_size=100)
    t = OPTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, ffn_dim=48, vocab_size=120,
                  max_position_embeddings=64, word_embed_proj_dim=32)
    model = Blip2ForConditionalGeneration(Blip2Config.from_vision_qformer_text_configs(v, q, t, num_query_tokens=4))
    model.eval()
    with torch.no_grad():  # break the zero and constant inits so the comparison means something
        for p in model.parameters():
            if (p == 0).all() or p.std() < 1e-8:
                p.add_(torch.randn_like(p) * 0.02)
    out = tmp_path_factory.mktemp("blip2_ckpt")
    model.save_pretrained(out)
    return out, model


def _hf_text_logits(hf, pixels_nchw, input_ids):
    """tests/test_blip2.py's composition: vision -> qformer -> projection ->
    OPT over [queries, text] with a plain causal mask."""
    with torch.no_grad():
        img = hf.vision_model(pixels_nchw).last_hidden_state
        qout = hf.qformer(query_embeds=hf.query_tokens.expand(img.shape[0], -1, -1),
                          encoder_hidden_states=img).last_hidden_state
        lm_in = hf.language_projection(qout)
        embeds = torch.cat([lm_in, hf.language_model.model.decoder.embed_tokens(input_ids)], dim=1)
        logits = hf.language_model(inputs_embeds=embeds, attention_mask=torch.ones(embeds.shape[:2],
                                                                                   dtype=torch.long)).logits
    return logits[:, lm_in.shape[1]:]


def test_load_blip2_matches_hf_without_transformers(tiny_hf_blip2, monkeypatch):
    from lemon_tpu_torch.models.blip2 import load_blip2

    ckpt, hf = tiny_hf_blip2
    monkeypatch.setitem(sys.modules, "transformers", None)  # the port must not need it
    model, cfg = load_blip2(ckpt, lora_rank=4, max_text_len=10, device=torch.device("cpu"))
    assert (cfg.vocab_size, cfg.n_queries, cfg.vision_mlp_dim, cfg.decoder_mlp_dim) == (120, 4, 48, 48)
    rng = np.random.default_rng(0)
    pixels = rng.random((3, 56, 56, 3), np.float32)
    ids = rng.integers(3, 100, (3, 10))
    ids[:, 0] = cfg.bos_token_id
    with torch.no_grad():
        ours = model(torch.from_numpy(pixels), torch.from_numpy(ids)).numpy()
    monkeypatch.undo()
    theirs = _hf_text_logits(hf, torch.from_numpy(pixels.transpose(0, 3, 1, 2)), torch.from_numpy(ids)).numpy()
    assert ours.shape == theirs.shape == (3, 10, 120)
    assert np.abs(ours - theirs).max() <= TOL
    lora = [n for n, _ in model.named_parameters() if n.endswith("lora_b")]
    assert lora and all(not p.any() for n, p in model.named_parameters() if n.endswith("lora_b"))


def test_blip2_config_defaults_and_refusals():
    from transformers import Blip2Config as HfBlip2Config

    from lemon_tpu_torch.models.blip2 import blip2_config_from_hf

    hf = HfBlip2Config()  # every field at its default: what an omitted key means
    cfg = blip2_config_from_hf({})
    v, q, t = hf.vision_config, hf.qformer_config, hf.text_config
    assert (cfg.vision.vision_width, cfg.vision.vision_layers, cfg.vision.vision_heads, cfg.vision_mlp_dim,
            cfg.vision.image_resolution, cfg.vision.vision_patch_size) == (
        v.hidden_size, v.num_hidden_layers, v.num_attention_heads, v.intermediate_size, v.image_size, v.patch_size)
    assert (cfg.qformer_width, cfg.qformer_layers, cfg.qformer_heads, cfg.qformer_mlp_dim,
            cfg.cross_attention_freq, cfg.n_queries) == (q.hidden_size, q.num_hidden_layers, q.num_attention_heads,
                                                         q.intermediate_size, q.cross_attention_frequency,
                                                         hf.num_query_tokens)
    assert (cfg.vocab_size, cfg.decoder_width, cfg.decoder_layers, cfg.decoder_heads, cfg.decoder_mlp_dim,
            cfg.max_positions, cfg.pad_token_id, cfg.bos_token_id, cfg.eos_token_id) == (
        t.vocab_size, t.hidden_size, t.num_hidden_layers, t.num_attention_heads, t.ffn_dim,
        t.max_position_embeddings, t.pad_token_id, t.bos_token_id, t.eos_token_id)
    for bad in ({"text_config": {"model_type": "t5"}}, {"text_config": {"hidden_size": 64, "word_embed_proj_dim": 32}},
                {"text_config": {"do_layer_norm_before": False}}):
        with pytest.raises(ValueError, match="not modelled"):
            blip2_config_from_hf(bad)
