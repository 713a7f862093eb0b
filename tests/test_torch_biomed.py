"""The port's BiomedCLIP (``lemon_tpu_torch.models.biomed``,
``bert_text`` and ``wordpiece``) against the JAX package and against
``transformers``' ``BertTokenizerFast``, at tiny sizes.

Both packages hold the same weights: a JAX ``init_biomed`` tree, every leaf
perturbed by seeded noise (a fresh init has zero biases and unit LayerNorms,
which would hide a swapped or missing one), through ``from_flax_params``.
Bars: both towers within 1e-5 (rtol and atol; fp32 with another summation
order), with padded tokens. The port's vision MLP takes the exact GELU of
timm's ViT where the JAX tower calls ``jax.nn.gelu`` (the tanh
approximation), so the JAX side runs with ``jax.nn.gelu`` patched to
``approximate=False`` inside the test; the open_clip state-dict conversion bit-equal;
the WordPiece ids equal to ``BertTokenizerFast``'s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import BertTokenizerFast

from lemon_tpu.models import biomed as jbiomed
from lemon_tpu_torch.models.biomed import BiomedClipConfig, BiomedClipModel, from_open_clip_state_dict, init_biomed
from lemon_tpu_torch.models.convert import from_flax_params
from lemon_tpu_torch.models.wordpiece import WordPieceTokenizer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed_jax_biomed(seed: int):
    jmodel, params = jbiomed.init_biomed(jbiomed.BiomedClipConfig.tiny(), seed=seed)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), params)
    return jmodel, params


def _bert_tokens(b: int, ctx: int, vocab: int, seed: int) -> np.ndarray:
    """[CLS] (id 2), a few ids, [SEP] (id 3), zero padding; the last row fills the context."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, ctx), np.int32)
    for r in range(b):
        n = min(2 + 3 * r, ctx - 2)
        tokens[r, 0] = 2
        tokens[r, 1 : n + 1] = rng.integers(5, vocab, n)
        tokens[r, n + 1] = 3
    return tokens


@pytest.fixture
def exact_jax_gelu(monkeypatch):
    """``jax.nn.gelu`` with the exact default, as timm's ViT computes it."""
    monkeypatch.setattr(jax.nn, "gelu", functools.partial(jax.nn.gelu, approximate=False))


def test_towers_match_jax_with_padded_tokens(exact_jax_gelu):
    jmodel, params = _perturbed_jax_biomed(seed=0)
    cfg = BiomedClipConfig.tiny()
    model = BiomedClipModel(cfg)
    model.load_state_dict(from_flax_params(params))
    rng = np.random.default_rng(1)
    pixels = rng.standard_normal((4, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = _bert_tokens(6, cfg.context_length, cfg.text.vocab_size, seed=2)
    assert (tokens == 0).any() and (tokens != 0).all(axis=0)[:2].all()
    with torch.no_grad():
        img = model.eval().encode_image(torch.from_numpy(pixels)).numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).numpy()
    jimg = np.asarray(jmodel.apply(params, jnp.asarray(pixels), method="encode_image"))
    jtxt = np.asarray(jmodel.apply(params, jnp.asarray(tokens), method="encode_text"))
    assert img.shape == (4, 16) and txt.shape == (6, 16)
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(txt, jtxt, rtol=1e-5, atol=1e-5)


def test_vision_mlp_takes_the_exact_gelu():
    """The tanh-approximate GELU gives another tower: the port's vision
    embedding stays within 1e-5 of JAX's only with the exact one."""
    jmodel, params = _perturbed_jax_biomed(seed=0)
    cfg = BiomedClipConfig.tiny()
    model = BiomedClipModel(cfg)
    model.load_state_dict(from_flax_params(params))
    pixels = np.random.default_rng(1).standard_normal((4, cfg.image_resolution, cfg.image_resolution, 3))
    pixels = pixels.astype(np.float32)
    with torch.no_grad():
        img = model.eval().encode_image(torch.from_numpy(pixels)).numpy()
    tanh = np.asarray(jmodel.apply(params, jnp.asarray(pixels), method="encode_image"))
    assert np.abs(img - tanh).max() > 1e-4  # what the JAX tower computes by default
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "gelu", functools.partial(jax.nn.gelu, approximate=False))
        exact = np.asarray(jmodel.apply(params, jnp.asarray(pixels), method="encode_image"))
    np.testing.assert_allclose(img, exact, rtol=1e-5, atol=1e-5)


def test_padding_is_masked():
    """A padded key changes nothing: extending a row with more padding (id 0)
    leaves the CLS embedding as it was."""
    cfg = BiomedClipConfig.tiny()
    model = init_biomed(BiomedClipModel(cfg), seed=3).eval()
    short = _bert_tokens(3, 8, cfg.text.vocab_size, seed=4)
    long = np.zeros((3, cfg.context_length), np.int32)
    long[:, :8] = short
    with torch.no_grad():
        a = model.encode_text(torch.from_numpy(short).long())
        b = model.encode_text(torch.from_numpy(long).long())
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _open_clip_state_dict(cfg: BiomedClipConfig, seed: int) -> dict:
    """A random open_clip BiomedCLIP state dict (timm trunk, HF BERT, MLP head)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)

    v, t = cfg.vision, cfg.text
    w, p, g = v.vision_width, v.vision_patch_size, v.grid
    put("visual.trunk.patch_embed.proj.weight", w, 3, p, p)
    put("visual.trunk.patch_embed.proj.bias", w)
    put("visual.trunk.cls_token", 1, 1, w)
    put("visual.trunk.pos_embed", 1, g * g + 1, w)
    for i in range(v.vision_layers):
        bp = f"visual.trunk.blocks.{i}."
        for name, shape in (("norm1", (w,)), ("norm2", (w,)), ("attn.qkv", (3 * w, w)), ("attn.proj", (w, w)),
                            ("mlp.fc1", (4 * w, w)), ("mlp.fc2", (w, 4 * w))):
            put(bp + name + ".weight", *shape)
            put(bp + name + ".bias", shape[0])
    put("visual.trunk.norm.weight", w)
    put("visual.trunk.norm.bias", w)
    put("visual.head.proj.weight", v.embed_dim, w)
    h, pre = t.hidden_size, "text.transformer."
    put(pre + "embeddings.word_embeddings.weight", t.vocab_size, h)
    put(pre + "embeddings.position_embeddings.weight", t.max_position_embeddings, h)
    put(pre + "embeddings.token_type_embeddings.weight", t.type_vocab_size, h)
    put(pre + "embeddings.LayerNorm.weight", h)
    put(pre + "embeddings.LayerNorm.bias", h)
    for i in range(t.num_layers):
        lp = f"{pre}encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("attention.output.LayerNorm", (h,)), ("intermediate.dense", (t.intermediate_size, h)),
                            ("output.dense", (h, t.intermediate_size)), ("output.LayerNorm", (h,))):
            put(lp + name + ".weight", *shape)
            put(lp + name + ".bias", shape[0])
    mid = (h + t.embed_dim) // 2
    put("text.proj.0.weight", mid, h)
    put("text.proj.0.bias", mid)
    put("text.proj.2.weight", t.embed_dim, mid)
    sd["logit_scale"] = np.array(np.log(1 / 0.07), np.float32)
    return sd


def test_open_clip_conversion_matches_jax():
    cfg = BiomedClipConfig.tiny()
    sd = _open_clip_state_dict(cfg, seed=5)
    tree, got_cfg = from_open_clip_state_dict(sd, cfg)
    jtree, _ = jbiomed.from_open_clip_state_dict(sd, jbiomed.BiomedClipConfig.tiny())
    ours, theirs = from_flax_params(tree), from_flax_params(jtree)
    assert got_cfg == cfg
    assert ours.keys() == theirs.keys() == BiomedClipModel(cfg).state_dict().keys()
    for key in ours:
        assert torch.equal(ours[key], theirs[key]), key


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "run", "##ning", "##s", "un", "##aff",
         "##able", "cafe", "naive", "the", "a", "x", "##x", ",", ".", "!", "?", "-", "(", ")", "'", "日", "本",
         "語", "text", "chest", "pain", "##ful", "é", "ü", "scan", "##ned", "$", "5", "##0", "%", "aaa", "##aaa"]
TEXTS = [
    "Hello, world!",
    "HELLO World... running runs",
    "unaffable café naïve Ünïcödé",
    "日本語 text and 日本",
    "chest-pain (painful) $50% scanned?",
    "xyzzy unknown tokens here",
    "a" * 150,  # beyond 100 characters: one [UNK]
    "aaaaaaaaa aaaa x xxxx",
    "",
    "   \t\n  tabs\tand\nnewlines\r\n",
    "control\x00char\x07s and​zero-width�",
    "the " * 40,  # truncated at the context length
    "don't stop—it's “quoted” «text»",
]


@pytest.mark.parametrize("context_length", [16, 32])
def test_wordpiece_matches_bert_tokenizer_fast(tmp_path, context_length):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    ref = BertTokenizerFast(vocab_file=str(path))
    want = np.asarray(ref(TEXTS, padding="max_length", truncation=True, max_length=context_length)["input_ids"])
    got = WordPieceTokenizer(path)(TEXTS, context_length)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), context_length)
    for text, a, b in zip(TEXTS, got, want):
        np.testing.assert_array_equal(a, b, err_msg=repr(text))


def test_wordpiece_needs_the_special_tokens(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("hello\nworld\n", encoding="utf-8")
    with pytest.raises(ValueError, match=r"\[UNK\]"):
        WordPieceTokenizer(path)
