"""ModifiedResNet vision tower in PyTorch (port of lemon_tpu/models/resnet.py).

OpenAI CLIP's RN family (reference: chexzero_clip.py:34-174), module for
module as the JAX package writes it:

- a 3-conv stem (stride 2, then 1, 1) and a 2x2 average pool;
- Bottleneck blocks whose convolutions all have stride 1, an average pool
  doing the downsampling, also in front of the 1x1 projection of the skip;
- BatchNorm at inference (``FrozenBatchNorm``: the running statistics as
  an affine map, computed in fp32 and cast to the compute dtype);
- a QKV attention pool over the final feature map with a learned position
  embedding that computes only the mean-token query, the one output row the
  reference keeps (chexzero_clip.py:117).

The convolutions are torch's (cuDNN on the card; the JAX package left them
to XLA, outside any Pallas kernel), in NCHW; the tower takes NHWC pixels, as
the JAX one, and transposes once. TF32 stays off
(``core/device.resolve_device``). The precision follows JAX: the compute
dtype alone (lemon_tpu/models/resnet.py:68-87), softmax in fp32. The
embedding is returned in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm2d over NCHW: ``x * inv + (bias - mean * inv)``
    with ``inv = weight / sqrt(var + eps)`` in fp32, cast to ``x``'s dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, dtype=torch.float32) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False, dtype=dtype)


class Bottleneck(nn.Module):
    """chexzero_clip.py:34-78: expansion 4, striding by average pooling."""

    EXPANSION = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        out_ch = planes * self.EXPANSION
        self.stride = stride
        self.conv1, self.bn1 = _conv(in_ch, planes, 1, dtype=dtype), FrozenBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, dtype=dtype), FrozenBatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, out_ch, 1, dtype=dtype), FrozenBatchNorm(out_ch)
        self.has_down = stride > 1 or in_ch != out_ch
        if self.has_down:
            self.down_conv, self.down_bn = _conv(in_ch, out_ch, 1, dtype=dtype), FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.has_down:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.down_bn(self.down_conv(identity))
        return F.relu(y + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pool (chexzero_clip.py:81-117) with the mean-token
    query only: the same row as the reference's ``x[0]``."""

    def __init__(self, spatial: int, width: int, heads: int, output_dim: int, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spatial * spatial + 1, width))
        self.q_proj = nn.Linear(width, width, dtype=dtype)
        self.k_proj = nn.Linear(width, width, dtype=dtype)
        self.v_proj = nn.Linear(width, width, dtype=dtype)
        self.c_proj = nn.Linear(width, output_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: (B, C, H, W) -> (B, output_dim)."""
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        x = torch.cat([x.float().mean(1, keepdim=True).to(x.dtype), x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        hd = c // self.heads
        q = self.q_proj(x[:, :1]).reshape(b, 1, self.heads, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(b, -1, self.heads, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(b, -1, self.heads, hd).transpose(1, 2)
        logits = (q * hd ** -0.5).float() @ k.float().transpose(-1, -2)
        out = torch.softmax(logits, dim=-1).to(v.dtype) @ v  # (B, H, 1, hd)
        return self.c_proj(out.transpose(1, 2).reshape(b, c))


class ResNetVisionTower(nn.Module):
    """ModifiedResNet (chexzero_clip.py:120-174). ``cfg.vision_layers`` is
    the 4-tuple of Bottleneck counts; the width doubles per stage and the
    pooled width is ``vision_width * 32``."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        layers: Tuple[int, ...] = tuple(cfg.vision_layers)
        width = cfg.vision_width
        self.stem_conv1, self.stem_bn1 = _conv(3, width // 2, 3, 2, dtype), FrozenBatchNorm(width // 2)
        self.stem_conv2, self.stem_bn2 = _conv(width // 2, width // 2, 3, dtype=dtype), FrozenBatchNorm(width // 2)
        self.stem_conv3, self.stem_bn3 = _conv(width // 2, width, 3, dtype=dtype), FrozenBatchNorm(width)
        self.block_names = []
        in_ch = width
        for stage, n_blocks in enumerate(layers):
            planes = width * 2 ** stage
            for j in range(n_blocks):
                name = f"layer{stage + 1}_{j}"
                self.add_module(name, Bottleneck(in_ch, planes, 2 if stage > 0 and j == 0 else 1, dtype))
                self.block_names.append(name)
                in_ch = planes * Bottleneck.EXPANSION
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, in_ch, cfg.v_heads, cfg.embed_dim, dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """``pixels``: (B, H, W, 3) NHWC, already normalised; fp32 result."""
        x = pixels.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        x = F.relu(self.stem_bn2(self.stem_conv2(x)))
        x = F.relu(self.stem_bn3(self.stem_conv3(x)))
        x = F.avg_pool2d(x, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.attnpool(x).float()
