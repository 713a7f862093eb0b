"""The yardstick's arithmetic: the card's peaks, a kernel's least time, and
the least model FLOPs a detection's outputs need (each tower's from the
configuration's architecture module; :func:`image_flops` and
:func:`text_flops` count OpenAI CLIP's, :mod:`portbench.arch.openai_clip`).

Peaks of one NVIDIA H100 SXM (NVIDIA's H100 Tensor Core GPU data sheet,
dense rates without sparsity, at the 700 W power limit): 989 TFLOP/s bf16,
1,979 TOP/s int8, 495 TFLOP/s TF32, 67 TFLOP/s fp32 outside the tensor
cores, 3.35 TB/s of HBM3. A share is stated against these with the card's
power limit beside it (the result line's ``device.power_limit_w``).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from portbench import arch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}


def bound_s(n_bytes: float, n_ops: float, peak: str) -> Tuple[float, str]:
    """(seconds, what sets it): the larger of the bytes over the HBM rate
    and the operations over the peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[peak]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_search_bound_s(n_queries: int, n_db: int, dim: int) -> float:
    """K1 at ``high`` over one search: the three bf16 products that its
    accuracy needs (2 * 3 * Nq * Ndb * D operations) against the bf16 peak,
    or the fp32 queries and database read once, whichever is longer."""
    return bound_s(4.0 * (n_queries + n_db) * dim, 3 * 2.0 * n_queries * n_db * dim, "bf16")[0]


def _block(n: int, width: int, pairs: float) -> float:
    """One pre-LN block over ``n`` tokens whose attention scores ``pairs``
    (query, key) pairs: q|k|v, output and the 4x MLP products (24 n w^2),
    and q.k and p.v (2 w FLOPs a pair each)."""
    return 24.0 * n * width * width + 4.0 * width * pairs


def _pooled_block(n: int, width: int) -> float:
    """The last block for one pooled row: k and v over all ``n`` tokens,
    the rest of the block for the pooled row alone."""
    return 4.0 * n * width * width + 20.0 * width * width + 4.0 * n * width


def image_flops(cfg: dict) -> float:
    """One image: the patch product, every token through all blocks but
    the last, the last for the class row, the projection."""
    w, p = cfg["vision_width"], cfg["vision_patch_size"]
    patches = (cfg["image_resolution"] // p) ** 2
    n = patches + 1
    return (2.0 * patches * p * p * 3 * w + (cfg["vision_layers"] - 1) * _block(n, w, n * n)
            + _pooled_block(n, w) + 2.0 * w * cfg["embed_dim"])


def text_flops(cfg: dict, length: int) -> float:
    """One text of ``length`` positions up to and with its EOT: causal
    attention over those positions, the last block for the EOT row."""
    w, n = cfg["text_width"], length
    return ((cfg["text_layers"] - 1) * _block(n, w, n * (n + 1) / 2) + _pooled_block(n, w)
            + 2.0 * w * cfg["embed_dim"])


def search_flops(n_queries: int, n_db: int, dim: int) -> float:
    return 2.0 * n_queries * n_db * dim


def detection_flops(cfg: dict, n_images: int, text_lengths: Iterable[int],
                    searches: Sequence[Tuple[int, int]]) -> float:
    """A detection's least model FLOPs: every image, every text at its
    length, and each search's (queries, database rows) product."""
    model = arch.of(cfg)
    return (n_images * model.image_flops(cfg) + sum(model.text_flops(cfg, n) for n in text_lengths)
            + sum(search_flops(q, d, model.embed_dim(cfg)) for q, d in searches))
