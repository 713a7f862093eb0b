"""What ``openai_clip`` may not move, read from the harness before the
architecture modules existed: the seeded weights, each configuration's FLOP
counts, and the reference's embeddings of a fixed tiny batch."""

import hashlib

import numpy as np
import pytest
import torch

from portbench import arch, harness
from portbench.tests.tiny import TINY
from portbench.weights import make_weights

CPU = torch.device("cpu")

WEIGHTS_SHA256 = {5: "ca1189c916af3f9ff4ceaad9e9bc4dfa984d30fd0ba72a1e83d1a15d23112626",
                  2**33 + 5: "8e31b155852fa5fa913ce317e85f23b1f8bb8144e3d340886c76db501fe46e24"}

# image, text at 77 positions, text at 256 positions
FLOPS = {"clip-vit-b16-mimic-bf16": (32696573952.0, 5483442176.0, 18732810240.0),
         "clip-vit-b32-bf16": (8232069120.0, 5483180032.0, 18732548096.0),
         "clip-vit-b32-fp32": (8232069120.0, 5483180032.0, 18732548096.0)}

# the first eight coordinates of each row at TINY, weights of seed 11
IMAGE_EMB = [[-0.0160932, 0.1082832, -0.0457783, -0.1825934, 0.0279351, -0.3263002, -0.0801742, -0.0787297],
             [-0.1678726, 0.0184962, 0.022979, -0.0697447, -0.0284177, -0.134914, -0.1093907, -0.0258704],
             [-0.1161414, 0.0978939, -0.1065809, -0.0793474, 0.059235, -0.1697687, -0.1465902, 0.0762539]]
TEXT_EMB = [[0.2864074, -0.1486248, 0.0311037, -0.0617796, -0.2243084, -0.0700062, -0.201703, -0.1161596],
            [0.183861, 0.2746928, -0.2253264, 0.2418424, 0.1549155, -0.0801556, 0.2271248, 0.1888152],
            [-0.0329563, -0.3175185, -0.0070742, -0.2248856, -0.2430272, 0.1303427, 0.0932212, -0.3323918]]


@pytest.mark.parametrize("seed", sorted(WEIGHTS_SHA256))
def test_the_seeded_weights_are_pinned(seed):
    h = hashlib.sha256()
    for name, w in make_weights(TINY, seed, CPU).items():
        h.update(name.encode())
        h.update(w.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS_SHA256[seed]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_the_flop_counts_are_pinned(name):
    cfg = harness.load_json(harness.PKG / "configs" / f"{name}.json")
    model = arch.of(cfg)
    assert (model.image_flops(cfg), model.text_flops(cfg, 77), model.text_flops(cfg, 256)) == FLOPS[name]


def test_the_reference_embeddings_are_pinned():
    W = make_weights(TINY, 11, CPU)
    ref = arch.of(TINY)
    images = np.random.default_rng(3).integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    pixels = ref.preprocess(torch.from_numpy(images), TINY)
    tokens = torch.from_numpy(ref.tokenize(["a photo of a cat", "two dogs on a beach at night", "no acute process"],
                                           TINY))
    with torch.no_grad():
        img = ref.encode_image(W, TINY, pixels)
        txt = ref.encode_text(W, TINY, tokens)
    np.testing.assert_allclose(img[:, :8].numpy(), IMAGE_EMB, atol=1e-6)
    np.testing.assert_allclose(txt[:, :8].numpy(), TEXT_EMB, atol=1e-6)
