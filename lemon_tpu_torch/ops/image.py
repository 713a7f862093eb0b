"""CLIP image preprocessing on the device (port of lemon_tpu/ops/image.py:36-159).

The reference's torchvision pipeline (lib/datasets/utils.py:163-170:
bicubic Resize(224) -> CenterCrop(224) -> ToTensor -> Normalize) becomes a
separable resize written as two fp32 matmuls, ``A_h @ img @ A_w^T`` per
channel, followed by crop and normalise. The weight matrices replicate PIL's
bicubic convolution exactly (half-pixel centres, antialias support widening
on downscale, per-row normalisation), and PIL's uint8 rounding between the
two passes is emulated, so outputs match PIL within its fixed-point rounding.
The bf16 fast path (``pil_rounding=False, precision="default"``) drops the
rounding emulation and rounds the products' operands to bf16, as the TPU's
one-pass DEFAULT precision does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.core.device import resolve_device

# CLIP normalization constants (lib/datasets/utils.py:159-160).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """PIL's bicubic kernel (Keys, a = -0.5)."""
    ax = np.abs(x)
    return np.where(
        ax < 1,
        ((a + 2) * ax - (a + 3)) * ax * ax + 1,
        np.where(ax < 2, a * (((ax - 5) * ax + 8) * ax - 4), 0.0),
    )


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic bicubic interpolation matrix with
    PIL semantics: half-pixel centres, kernel stretched by the scale factor
    when downscaling, taps outside the image dropped before normalising."""
    scale = in_size / out_size
    filter_scale = max(scale, 1.0)
    support = 2.0 * filter_scale
    mat = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        js = np.arange(lo, hi)
        w = _cubic_kernel((js + 0.5 - center) / filter_scale)
        mat[i, js] = w / w.sum()
    return mat.astype(np.float32)


def center_crop_bounds(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision CenterCrop offsets: round half down."""
    return int(round((h - size) / 2.0)), int(round((w - size) / 2.0))


def resize_shorter_side(h: int, w: int, target: int) -> Tuple[int, int]:
    """torchvision Resize(int): shorter side -> target, long edge truncated
    (``int(target * long / short)``)."""
    if h <= w:
        return target, max(int(target * w / h), 1)
    return max(int(target * h / w), 1), target


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL's fixed-point rounding between resample passes: round half up,
    clip to [0, 255]."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def _split_bf16(x: torch.Tensor):
    """(hi, lo) as fp32: hi = bf16(x), lo = bf16(x - hi), both rounded to
    nearest even (ops/scoremax.split_bf16_plain without its padding)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _resize_product(eq: str, a: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """One resize pass at a JAX matmul precision, on any device: 'highest'
    is fp32; 'high' is bf16x3, the three bf16 products of K1 'high',
    ``hi.hi + (hi.lo + lo.hi)`` with fp32 sums; 'default' is the TPU's one
    bf16 pass (operands rounded to bf16, products exact and summed in
    fp32)."""
    if precision == "highest":
        return torch.einsum(eq, a, x)
    if precision == "high":
        (a_hi, a_lo), (x_hi, x_lo) = _split_bf16(a), _split_bf16(x)
        return torch.einsum(eq, a_hi, x_hi) + (torch.einsum(eq, a_hi, x_lo) + torch.einsum(eq, a_lo, x_hi))
    if precision == "default":
        return torch.einsum(eq, a.bfloat16().float(), x.bfloat16().float())
    raise ValueError(f"precision must be 'highest', 'high' or 'default', got {precision!r}")


def _upload(t: torch.Tensor, device, non_blocking: bool = False) -> torch.Tensor:
    """``t.to(device)``; a host tensor's bytes count as ``h2d_bytes`` of the
    open span (on a CPU device no copy is made, and the count is the same)."""
    if t.device.type == "cpu":
        profiling.count("h2d_bytes", t.nbytes)
    return t.to(device, non_blocking=non_blocking)


def preprocess_device(images_u8, size: int = 224, device=None, mean=CLIP_MEAN, std=CLIP_STD,
                      pil_rounding: bool = True, precision: str = "highest") -> torch.Tensor:
    """(B, H, W, 3) uint8 images (numpy or tensor) -> (B, size, size, 3)
    float32 NHWC on ``device``. ``device=None`` keeps a tensor on its own
    device and sends anything else to the current CUDA card
    (``resolve_device("cuda")``, which raises without one); pass
    ``torch.device("cpu")`` to preprocess on the CPU.

    ``pil_rounding=False`` skips the uint8 intermediate emulation.
    ``precision`` is the matmul precision of the two resize passes, as in
    lemon_tpu/ops/image.py:125-159: 'highest' (fp32, the PIL-parity
    default), 'high' (bf16x3: three bf16 products with fp32 sums) or
    'default' (one bf16 pass: the bf16 fast path's choice; uint8 pixels are
    exact in bf16)."""
    if device is None and not isinstance(images_u8, torch.Tensor):
        device = resolve_device("cuda")
    x = torch.as_tensor(images_u8)
    if device is not None:
        x = _upload(x, device, non_blocking=True)
    b, h, w, _ = x.shape
    out_h, out_w = resize_shorter_side(h, w, size)
    a_h = _upload(torch.from_numpy(resize_matrix(h, out_h)), x.device)
    a_w = _upload(torch.from_numpy(resize_matrix(w, out_w)), x.device)
    x = x.float()
    # PIL resamples horizontally first and stores a uint8 intermediate.
    x = _resize_product("ow,bhwc->bhoc", a_w, x, precision)
    if pil_rounding:
        x = _round_u8(x)
    x = _resize_product("oh,bhwc->bowc", a_h, x, precision)
    if pil_rounding:
        x = _round_u8(x)
    top, left = center_crop_bounds(out_h, out_w, size)
    x = x[:, max(top, 0) : max(top, 0) + size, max(left, 0) : max(left, 0) + size, :]
    mean_t = _upload(torch.from_numpy(np.asarray(mean, np.float32)), x.device)
    std_t = _upload(torch.from_numpy(np.asarray(std, np.float32)), x.device)
    return ((x / 255.0 - mean_t) / std_t).contiguous()


def pil_resize_crop_u8(arr: np.ndarray, size: int) -> np.ndarray:
    """torchvision ``Resize(size, bicubic) + CenterCrop(size)`` on a uint8
    HWC array via PIL, byte-exact with the reference's transform; unifies
    mixed image sizes on the host before a batch is assembled."""
    from PIL import Image

    im = Image.fromarray(np.asarray(arr, np.uint8))
    h, w = arr.shape[:2]
    out_h, out_w = resize_shorter_side(h, w, size)
    im = im.resize((out_w, out_h), Image.BICUBIC)
    top, left = center_crop_bounds(out_h, out_w, size)
    im = im.crop((left, top, left + size, top + size))
    return np.asarray(im, np.uint8)
