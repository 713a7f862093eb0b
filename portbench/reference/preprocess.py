"""CLIP image preprocessing as the reference defines it (frozen copy).

torchvision's ``Resize(size, BICUBIC)``, ``CenterCrop(size)``, ``ToTensor``
and CLIP's ``Normalize``: PIL's separable bicubic (Keys, a = -0.5, half-pixel
centres, the support widened by the scale on a downscale, taps outside the
image dropped and the row renormalised), horizontal pass first, each pass
rounded to uint8 as PIL stores it. fp32 products; NHWC output.
"""

from __future__ import annotations

import numpy as np
import torch

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1, ((a + 2) * ax - (a + 3)) * ax * ax + 1,
                    np.where(ax < 2, a * (((ax - 5) * ax + 8) * ax - 4), 0.0))


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bicubic weights with PIL's semantics."""
    scale = n_in / n_out
    stretch = max(scale, 1.0)
    mat = np.zeros((n_out, n_in))
    for i in range(n_out):
        centre = (i + 0.5) * scale
        lo, hi = max(int(centre - 2 * stretch + 0.5), 0), min(int(centre + 2 * stretch + 0.5), n_in)
        taps = np.arange(lo, hi)
        w = _cubic((taps + 0.5 - centre) / stretch)
        mat[i, taps] = w / w.sum()
    return mat.astype(np.float32)


def preprocess(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 on any device -> (B, size, size, 3) fp32."""
    b, h, w, _ = images_u8.shape
    oh, ow = (size, max(int(size * w / h), 1)) if h <= w else (max(int(size * h / w), 1), size)
    dev = images_u8.device
    a_h = torch.from_numpy(resize_weights(h, oh)).to(dev)
    a_w = torch.from_numpy(resize_weights(w, ow)).to(dev)
    x = images_u8.float()
    x = torch.clamp(torch.floor(torch.einsum("ow,bhwc->bhoc", a_w, x) + 0.5), 0, 255)
    x = torch.clamp(torch.floor(torch.einsum("oh,bhwc->bowc", a_h, x) + 0.5), 0, 255)
    top, left = int(round((oh - size) / 2.0)), int(round((ow - size) / 2.0))
    x = x[:, top: top + size, left: left + size]
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    return ((x / 255.0 - mean) / std).contiguous()
