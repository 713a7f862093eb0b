"""``detect_mfu``'s FLOP count against a count by hand, product by product,
at the ViT-B/32 and the MIMIC ViT-B/16 widths."""

import pytest

from portbench import harness
from portbench.roofline import detection_flops, image_flops, k1_search_bound_s, text_flops

B32 = harness.load_json(harness.PKG / "configs" / "clip-vit-b32-fp32.json")
B16 = harness.load_json(harness.PKG / "configs" / "clip-vit-b16-mimic-bf16.json")


def _by_hand_image(w, p, layers, embed, res=224):
    g = res // p
    n = g * g + 1
    total = 2 * (n - 1) * (p * p * 3) * w  # patch product
    for _ in range(layers - 1):
        total += 2 * n * w * 3 * w  # q, k, v
        total += 2 * n * n * w + 2 * n * n * w  # q.k over all heads, p.v
        total += 2 * n * w * w  # attention output
        total += 2 * n * w * 4 * w + 2 * n * 4 * w * w  # MLP
    # last block, class row only: k and v of every token, the rest for one row
    total += 2 * n * w * 2 * w + 2 * w * w + 2 * n * w + 2 * n * w + 2 * w * w + 2 * w * 4 * w + 2 * 4 * w * w
    return total + 2 * w * embed


def _by_hand_text(w, layers, embed, n):
    pairs = sum(i + 1 for i in range(n))  # causal
    total = 0
    for _ in range(layers - 1):
        total += 2 * n * w * 3 * w + 2 * pairs * w * 2 + 2 * n * w * w + 2 * n * w * 8 * w
    total += 2 * n * w * 2 * w + 2 * w * w + 4 * n * w + 2 * w * w + 16 * w * w
    return total + 2 * w * embed


def test_b32_image():
    assert image_flops(B32) == _by_hand_image(768, 32, 12, 512) == 8_232_069_120


def test_b16_image():
    assert image_flops(B16) == _by_hand_image(768, 16, 12, 768)
    assert 32.6e9 < image_flops(B16) < 32.8e9


@pytest.mark.parametrize("cfg,n", [(B32, 10), (B32, 77), (B16, 165), (B16, 256)])
def test_text_at_its_length(cfg, n):
    assert text_flops(cfg, n) == pytest.approx(_by_hand_text(cfg["text_width"], cfg["text_layers"],
                                                             cfg["embed_dim"], n), rel=1e-12)


def test_a_detection_adds_images_texts_and_searches():
    got = detection_flops(B32, 3, [10, 12, 77], [(5, 40), (5, 40)])
    want = 3 * _by_hand_image(768, 32, 12, 512) + sum(_by_hand_text(512, 12, 512, n) for n in (10, 12, 77)) \
        + 2 * (2 * 5 * 40 * 512)
    assert got == pytest.approx(want, rel=1e-12)


def test_k1_bound_is_three_bf16_products_when_the_search_is_wide():
    # 8192 x 40000 x 512: 3 * 2 * 8192 * 40000 * 512 operations at 989 TFLOP/s
    assert k1_search_bound_s(8192, 40000, 512) == pytest.approx(6 * 8192 * 40000 * 512 / 989e12)
    # a single query is bound by reading the database
    assert k1_search_bound_s(1, 40000, 512) == pytest.approx(4 * 40001 * 512 / 3.35e12)
