"""The reference against the port at tiny widths on the CPU: the same
tokens, the same pixels, the same embeddings from the same weights; and the
operand roundings of its controls."""

import numpy as np
import pytest
import torch

from lemon_tpu_torch.models.tokenizer import tokenize_batch
from lemon_tpu_torch.ops.image import preprocess_device
from portbench import harness
from portbench.reference import clip as ref_clip
from portbench.reference.preprocess import preprocess
from portbench.reference.tokenizer import Tokenizer
from portbench.tests.tiny import TINY
from portbench.traffic import Traffic, load_mix
from portbench.weights import make_weights

CPU = torch.device("cpu")


def test_tokens_equal_the_programs():
    texts = ["A photo of a aquarium_fish", "a man  riding a red bike , near the beach", "no acute cardiopulmonary "
             "process . the heart size is normal ; mild bibasilar atelectasis", "x " * 300, ""]
    for mix in ("mimic-reports", "flickr30k"):
        t = Traffic(load_mix(mix) | {"images": {"size": 8, "channels": 1, "source": "pool", "pool_rows": 2}},
                    3, CPU)
        texts += t._captions(np.random.default_rng(0), 20)
    for ctx in (16, 77, 256):
        assert (Tokenizer()(texts, ctx) == tokenize_batch(texts, ctx)).all()


@pytest.mark.parametrize("hw", [(32, 32), (40, 40), (224, 224), (30, 50)])
def test_pixels_equal_the_programs(hw):
    images = np.random.default_rng(1).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    want = preprocess_device(images, size=32, device=CPU)
    got = preprocess(torch.from_numpy(images), 32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision,tol", [("fp32", 1e-5), ("bf16", 0.05)])
def test_embeddings_equal_the_programs(precision, tol):
    cfg = dict(TINY, precision=precision)
    W = make_weights(cfg, 11, CPU)
    enc = harness.build_encoder(cfg, W, CPU, 8, 11)
    tokens = torch.from_numpy(Tokenizer()(["a photo of a cat", "two dogs on a beach at night"] * 4, 16))
    pixels = preprocess(torch.from_numpy(np.random.default_rng(2).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)),
                        32)
    with torch.no_grad():
        for mine, theirs in ((ref_clip.encode_image(W, cfg, pixels), enc.model.encode_image(pixels)),
                             (ref_clip.encode_text(W, cfg, tokens), enc.model.encode_text(tokens))):
            theirs = theirs / theirs.norm(dim=-1, keepdim=True)
            assert (mine - theirs).abs().max().item() < tol


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -1.5 - 2**-12, 3.0e-30])
    got = ref_clip.round_tf32(x)
    assert got.tolist()[:4] == [1.0, 1 + 2**-10, 1.0, 1 + 2**-9]  # ties to even
    assert got[4].item() == -1.5
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()


def test_weights_are_a_function_of_the_seed():
    a, b, c = (make_weights(TINY, s, CPU) for s in (5, 5, 2**33 + 5))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["visual.proj"], c["visual.proj"])
