"""The classifier's other backbones (port of lemon_tpu/models/torch_backbones.py),
as the reference's get_img_base offers them (lib/models/utils.py:49-61):

- :class:`TvResNet50`, torchvision's ResNet-50 (v1.5: the stride on the 3x3
  conv) with the reference's 768-d ``fc`` (``fc = nn.Linear(2048, 768)``),
  under torchvision's module names (``conv1``, ``bn1``, ``layer{1-4}.{i}``
  with ``conv{1-3}``/``bn{1-3}`` and ``downsample.0/1``, ``fc``), so a
  torchvision state dict loads with ``load_state_dict``;
- :class:`GoogleViTEncoder`, HF ``ViTModel`` up to the CLS row of
  ``last_hidden_state`` (``google/vit-base-patch16-224``: 224 px, 12 x 768,
  12 heads, MLP 3072), LayerNorm eps 1e-12, the exact GELU, plain softmax
  attention.

Pixels arrive NHWC (``ops/image.preprocess_device``); the ResNet takes them
as an NCHW view of that memory, which is the ``channels_last`` layout.

BatchNorm is ``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5), torchvision's
semantics, which the JAX docstring names as the intent. Flax's BatchNorm
updates the running variance with the biased batch variance, torch with the
unbiased one (n/(n-1)); the running means agree (ROADMAP: handled
divergences).

:func:`from_tv_resnet50` and :func:`from_hf_vit` take the torchvision and HF
state-dict layouts (the counterparts of ``convert_tv_resnet50`` and
``convert_hf_vit``); :func:`init_backbone` is the JAX initialisers'
distributions from a seeded generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# torchvision-layout ResNet-50


class TvBottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 reduce -> 3x3 (the stride here) -> 1x1 x4
    expand, BatchNorm after every conv, ReLU after the residual add."""

    def __init__(self, inplanes: int, width: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * width)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, 4 * width, 1, stride=stride, bias=False), nn.BatchNorm2d(4 * width)
        ) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class TvResNet50(nn.Module):
    """torchvision ``resnet50`` with an ``embed_dim`` fc; (B, H, W, 3) NHWC
    pixels -> the (B, embed_dim) fc output."""

    def __init__(self, embed_dim: int = 768, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        # pads with -inf, as the JAX jnp.pad(-inf) before its max_pool
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = width
        for stage, blocks in enumerate(stage_sizes):
            w = width * 2 ** stage
            layer = []
            for b in range(blocks):
                layer.append(TvBottleneck(inplanes, w, stride=2 if stage > 0 and b == 0 else 1, downsample=b == 0))
                inplanes = 4 * w
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(inplanes, embed_dim)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(F.relu(self.bn1(self.conv1(pixels.permute(0, 3, 1, 2)))))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))  # AdaptiveAvgPool2d((1, 1))


def _tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def from_tv_resnet50(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision resnet50 state dict (after the fc replacement; tensors
    or arrays) -> :class:`TvResNet50`'s. The names are the same; a dict
    without BatchNorm's ``num_batches_tracked`` (which the momentum makes
    unused) gets zeros."""
    out = {k: v.float() if v.is_floating_point() else v for k, v in _tensors(sd).items()}
    for k in [k for k in out if k.endswith(".running_var")]:
        out.setdefault(k.replace(".running_var", ".num_batches_tracked"), torch.tensor(0))
    return out


# ---------------------------------------------------------------------------
# google ViT (HF ViTModel): the CLS-row encoder


@dataclasses.dataclass(frozen=True)
class GoogleViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072

    @property
    def image_resolution(self) -> int:  # uniform with ClipConfig / TvResNetSpec
        return self.image_size

    @staticmethod
    def tiny() -> "GoogleViTConfig":
        return GoogleViTConfig(image_size=32, patch_size=8, width=32, layers=2, heads=2, mlp_dim=48)


class GoogleViTBlock(nn.Module):
    """Pre-LN block: softmax attention over separate q/k/v projections, then
    the exact-GELU MLP (HF ViTLayer)."""

    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.ln_before = nn.LayerNorm(width, eps=1e-12)
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)
        self.attn_out = nn.Linear(width, width)
        self.ln_after = nn.LayerNorm(width, eps=1e-12)
        self.mlp_fc = nn.Linear(width, mlp_dim)
        self.mlp_out = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.heads
        y = self.ln_before(x)
        q, k, v = (p(y).reshape(b, l, self.heads, hd).transpose(1, 2) for p in (self.query, self.key, self.value))
        probs = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
        x = x + self.attn_out((probs @ v).transpose(1, 2).reshape(b, l, d))
        return x + self.mlp_out(F.gelu(self.mlp_fc(self.ln_after(x))))


class GoogleViTEncoder(nn.Module):
    """HF ViTModel's forward up to ``last_hidden_state[:, 0]``, the CLS
    embedding the classifier's head reads; (B, H, W, 3) NHWC pixels."""

    def __init__(self, cfg: GoogleViTConfig = GoogleViTConfig()):
        super().__init__()
        self.cfg = cfg
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patch_embedding = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.position_embeddings = nn.Parameter(torch.zeros(n, cfg.width))
        self.blocks = nn.ModuleList(GoogleViTBlock(cfg.width, cfg.heads, cfg.mlp_dim) for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-12)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # (B, grid^2, width)
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, -1), x], dim=1) + self.position_embeddings
        for block in self.blocks:
            x = block(x)
        return self.ln_final(x)[:, 0]


def from_hf_vit(sd: Mapping, cfg: GoogleViTConfig) -> Dict[str, torch.Tensor]:
    """An HF ViTModel state dict (tensors or arrays; the ``vit.``-prefixed
    ViTForImageClassification layout too, the name get_img_base loads)
    -> :class:`GoogleViTEncoder`'s."""
    sd = _tensors(sd)
    if any(k.startswith("vit.") for k in sd):
        sd = {k[4:]: v for k, v in sd.items() if k.startswith("vit.")}
    out = {
        "patch_embedding.weight": sd["embeddings.patch_embeddings.projection.weight"],
        "patch_embedding.bias": sd["embeddings.patch_embeddings.projection.bias"],
        "cls_token": sd["embeddings.cls_token"],
        "position_embeddings": sd["embeddings.position_embeddings"][0],
        "ln_final.weight": sd["layernorm.weight"],
        "ln_final.bias": sd["layernorm.bias"],
    }
    parts = {"ln_before": "layernorm_before", "query": "attention.attention.query",
             "key": "attention.attention.key", "value": "attention.attention.value",
             "attn_out": "attention.output.dense", "ln_after": "layernorm_after",
             "mlp_fc": "intermediate.dense", "mlp_out": "output.dense"}
    for i in range(cfg.layers):
        for ours, hf in parts.items():
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{leaf}"] = sd[f"encoder.layer.{i}.{hf}.{leaf}"]
    return {k: v.float() for k, v in out.items()}


@torch.no_grad()
def init_backbone(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX backbones' initialisers: ``lecun_normal`` weights and zero
    biases for every linear and conv layer, LayerNorm and BatchNorm at
    identity; the google-ViT's CLS token at zero and its position
    embeddings normal(0.02)."""
    from lemon_tpu_torch.models.clip import init_layers_

    init_layers_(module, generator)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, GoogleViTEncoder):
            m.cls_token.zero_()
            m.position_embeddings.normal_(0.0, 0.02, generator=generator)
    return module

