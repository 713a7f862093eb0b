"""The port's BLIP ITM tower (``models/blip_itm.py``, ``bert_text.BlipTextEncoder``)
against HuggingFace's and the JAX package's scorers, on the CPU.

The checkpoint is ``tests/tiny_checkpoints.build_tiny_blip_itm``'s, written
by ``save_pretrained`` (which omits every config key at HF's default). Bars:

- the loaded config equals ``BlipConfig.from_pretrained``'s, field by field;
  an unknown ``model_type`` or ``hidden_act`` raises;
- pixels equal ``BlipProcessor``'s exactly (the same PIL resize of uint8,
  the float64 rescale cast to float32, float32 normalisation), token ids and
  attention masks equal, on images of ragged sizes;
- ITM logits within 1e-5 of ``BlipForImageTextRetrieval``'s;
- P(match) within 1e-5 of the JAX package's ``hf_blip_itm_scorer``, and the
  CLIP proxy within 1e-5 of its ``clip_itm_proxy`` on one set of weights;
- a model that :func:`save_blip_itm` wrote (the port's safetensors writer)
  loads in HF to the same logits within 1e-5.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lemon_tpu_torch.models.blip_itm import (BlipItmConfig, BlipItmModel, blip_itm_config_from_hf, blip_itm_scorer,
                                             init_blip_itm, load_blip_itm, save_blip_itm)

CPU = torch.device("cpu")
CAPTIONS = ["a photo of a cat", "The dog, is on a PLANE!", "yes", "bird horse ship truck deer frog car a photo",
            "Is there a boy in the picture?", "no"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def itm_dir(tmp_path_factory):
    sys.path.insert(0, str(Path(__file__).parent))
    try:
        from tiny_checkpoints import build_tiny_blip_itm
    finally:
        sys.path.pop(0)
    return build_tiny_blip_itm(tmp_path_factory.mktemp("blip_itm"))


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (40 + 7 * i, 50 - 3 * i, 3), dtype=np.uint8) for i in range(6)]


def test_config_defaults_match_hf(itm_dir):
    from transformers import BlipConfig

    hf = BlipConfig.from_pretrained(itm_dir)
    raw = json.loads((Path(itm_dir) / "config.json").read_text())
    cfg = blip_itm_config_from_hf(raw)
    v, t = hf.vision_config, hf.text_config
    assert dataclasses.astuple(cfg.vision) == (v.hidden_size, v.intermediate_size, v.num_hidden_layers,
                                               v.num_attention_heads, v.image_size, v.patch_size, v.layer_norm_eps)
    assert (cfg.text.vocab_size, cfg.text.hidden_size, cfg.text.num_layers, cfg.text.num_heads,
            cfg.text.intermediate_size, cfg.text.max_position_embeddings, cfg.text.layer_norm_eps,
            cfg.text.encoder_hidden_size) == (t.vocab_size, t.hidden_size, t.num_hidden_layers, t.num_attention_heads,
                                              t.intermediate_size, t.max_position_embeddings, t.layer_norm_eps,
                                              t.encoder_hidden_size)
    # an empty config means HF's defaults everywhere
    empty = blip_itm_config_from_hf({"model_type": "blip"})
    hf_default = BlipConfig()
    assert empty.text.num_heads == hf_default.text_config.num_attention_heads == 8
    assert empty.vision.image_size == hf_default.vision_config.image_size == 384
    assert empty.text.encoder_hidden_size == hf_default.vision_config.hidden_size


@pytest.mark.parametrize("bad", [{"model_type": "blip_2"}, {"text_config": {"hidden_act": "relu"}},
                                 {"vision_config": {"hidden_act": "quick_gelu"}}])
def test_unknown_model_type_or_activation_raises(bad):
    with pytest.raises(ValueError, match="not modelled"):
        blip_itm_config_from_hf({"model_type": "blip", **bad})


def test_processor_and_tokens_match_blip_processor(itm_dir):
    from transformers import BlipProcessor

    proc = BlipProcessor.from_pretrained(itm_dir)
    itm = load_blip_itm(itm_dir, CPU)
    imgs = _images()
    ref = proc(images=imgs, text=CAPTIONS, return_tensors="pt", padding=True, truncation=True)
    pixels, ids, mask = itm.inputs(imgs, CAPTIONS)
    assert torch.equal(pixels.permute(0, 3, 1, 2), ref["pixel_values"])
    assert torch.equal(ids, ref["input_ids"]) and torch.equal(mask, ref["attention_mask"])


def test_itm_logits_match_hf(itm_dir):
    from transformers import BlipForImageTextRetrieval, BlipProcessor

    hf = BlipForImageTextRetrieval.from_pretrained(itm_dir).eval()
    proc = BlipProcessor.from_pretrained(itm_dir)
    itm = load_blip_itm(itm_dir, CPU)
    imgs = _images(1)
    with torch.no_grad():
        ref = hf(**proc(images=imgs, text=CAPTIONS, return_tensors="pt", padding=True, truncation=True)).itm_score
    got = itm.logits(imgs, CAPTIONS)
    assert got.shape == (len(CAPTIONS), 2)
    assert (got - ref).abs().max() <= 1e-5


def test_pmatch_matches_the_jax_scorer(itm_dir):
    from lemon_tpu.baselines.capfilt import hf_blip_itm_scorer

    imgs = _images(2) * 4  # 24 pairs: two batches of 16, the second ragged
    caps = CAPTIONS * 4
    ref = hf_blip_itm_scorer(itm_dir)(imgs, caps)
    got = blip_itm_scorer(itm_dir, CPU)(imgs, caps)
    assert got.shape == ref.shape == (24,) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5


def test_clip_proxy_matches_jax():
    from lemon_tpu.baselines.capfilt import clip_itm_proxy as jax_proxy
    from lemon_tpu.models.clip import ClipConfig, init_params
    from lemon_tpu.models.encoder import ClipEncoder as JaxEncoder
    from lemon_tpu_torch.baselines.capfilt import clip_itm_proxy
    from lemon_tpu_torch.models.clip import ClipConfig as PortConfig, ClipModel
    from lemon_tpu_torch.models.convert import from_flax_params
    from lemon_tpu_torch.models.encoder import ClipEncoder

    jax_model, params = init_params(ClipConfig.tiny(), seed=5)
    model = ClipModel(PortConfig.tiny())
    model.load_state_dict(from_flax_params(params))
    imgs = _images(3)[:5]  # ragged RGB sizes: unified by the PIL resize and crop
    caps = CAPTIONS[:5]
    ref = jax_proxy(JaxEncoder(jax_model, params, batch_size=8))(imgs, caps)
    got = clip_itm_proxy(ClipEncoder(model, CPU, batch_size=8))(imgs, caps)
    assert np.abs(got - ref).max() <= 1e-5


def test_saved_model_loads_in_hf(tmp_path):
    from transformers import BlipForImageTextRetrieval

    cfg = BlipItmConfig.tiny()
    model = init_blip_itm(BlipItmModel(cfg), seed=4)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(cfg.text.vocab_size - 5)]
    save_blip_itm(model, tmp_path / "ckpt", vocab)
    hf = BlipForImageTextRetrieval.from_pretrained(tmp_path / "ckpt").eval()
    back = load_blip_itm(tmp_path / "ckpt", CPU)
    imgs, caps = _images(4)[:3], ["w1 w2 w3", "w7", "w0 w0"]
    pixels, ids, mask = back.inputs(imgs, caps)
    with torch.no_grad():
        ref = hf(input_ids=ids, pixel_values=pixels.permute(0, 3, 1, 2), attention_mask=mask).itm_score
        mine = model(pixels, ids, mask)
    assert (back.logits(imgs, caps) - ref).abs().max() <= 1e-5
    assert torch.equal(back.logits(imgs, caps), mine)
