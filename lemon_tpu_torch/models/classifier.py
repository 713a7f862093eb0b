"""Supervised image classifier for downstream filter-then-train and the
training-dynamics baselines (port of lemon_tpu/models/classifier.py).

Counterpart of SuperviseClassifier (lib/models/downstream_models.py:45-108):
a vision backbone with a linear head, cross-entropy (or BCE for one
output), optionally a frozen backbone. The backbone follows the config's
type, as get_img_base follows its name (lib/models/utils.py:49-61):

- :class:`~lemon_tpu_torch.models.clip.ClipConfig` -> the port's CLIP ViT
  vision tower (plain attention, as the JAX classifier's XLA route),
- :class:`TvResNetSpec` -> the torchvision-layout ResNet-50 with the 768-d fc,
- :class:`~lemon_tpu_torch.models.torch_backbones.GoogleViTConfig` -> the
  HF ViTModel CLS encoder.

``freeze_backbone`` detaches the features, as JAX's ``stop_gradient``: the
backbone's parameters stay in the optimizer with zero gradients, so AdamW
still decays them (``lr·wd·p`` every step) and BatchNorm still updates its
running statistics in train mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from lemon_tpu_torch.models.clip import ClipConfig, VisionTower, init_layers_, init_vit_
from lemon_tpu_torch.models.torch_backbones import GoogleViTConfig, GoogleViTEncoder, TvResNet50, init_backbone


@dataclasses.dataclass(frozen=True)
class TvResNetSpec:
    """torchvision resnet50 backbone spec (get_img_base 'resnet50',
    lib/models/utils.py:50-53: fc replaced with Linear(2048, embed_dim))."""

    embed_dim: int = 768
    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    width: int = 64
    image_resolution: int = 224

    @staticmethod
    def tiny() -> "TvResNetSpec":
        return TvResNetSpec(embed_dim=32, stage_sizes=(1, 1, 1, 1), width=8, image_resolution=64)


class ImageClassifier(nn.Module):
    """``backbone`` + ``head``; (B, H, W, 3) NHWC pixels -> (B, num_classes)
    logits. ``train()`` is the JAX ``train=True``: BatchNorm backbones use
    and update batch statistics; the ViTs have no train-only layer."""

    def __init__(self, cfg: Any, num_classes: int, freeze_backbone: bool = False):
        super().__init__()
        self.cfg = cfg
        self.freeze_backbone = freeze_backbone
        if isinstance(cfg, TvResNetSpec):
            self.backbone = TvResNet50(cfg.embed_dim, tuple(cfg.stage_sizes), cfg.width)
            features = cfg.embed_dim
        elif isinstance(cfg, GoogleViTConfig):
            self.backbone = GoogleViTEncoder(cfg)
            features = cfg.width
        elif isinstance(cfg, ClipConfig):
            self.backbone = VisionTower(cfg)
            features = cfg.embed_dim
        else:
            raise TypeError(f"no classifier backbone for a {type(cfg).__name__}")
        self.head = nn.Linear(features, num_classes)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(pixels)
        if self.freeze_backbone:
            feats = feats.detach()
        return self.head(feats)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE for several classes, BCE-with-logits for one output
    (downstream_models.py:96-104), each as optax computes it: CE is
    ``logsumexp(row) - row[label]`` (no NLL loss, which has no deterministic
    CUDA implementation). ``mask``: per-row 0/1 validity; the padded rows of
    a wrap-padded last batch must not count, so the mean is over the valid
    rows (at least one)."""
    if logits.shape[-1] == 1:
        x, y = logits[:, 0], labels.to(logits.dtype)
        per = -y * nn.functional.logsigmoid(x) - (1.0 - y) * nn.functional.logsigmoid(-x)
    else:
        per = torch.logsumexp(logits, dim=-1) - logits.gather(1, labels.long()[:, None])[:, 0]
    if mask is None:
        return per.mean()
    mask = mask.to(per.dtype)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@torch.no_grad()
def init_classifier(cfg: Any, num_classes: int, seed: int = 0, freeze_backbone: bool = False,
                    backbone_state: Optional[Mapping[str, torch.Tensor]] = None) -> ImageClassifier:
    """Build and initialise on the host with the JAX initialisers'
    distributions from ``seed`` (the numbers differ from ``jax.random``'s;
    tests that need JAX's weights load them through
    :func:`lemon_tpu_torch.models.convert.classifier_from_flax`). A
    ``backbone_state`` (the backbone's state dict, BatchNorm statistics
    included) warm-starts the backbone, the 'use_pretrained' path of
    get_img_base."""
    model = ImageClassifier(cfg, num_classes, freeze_backbone=freeze_backbone)
    g = torch.Generator().manual_seed(seed)
    if isinstance(cfg, ClipConfig):
        init_layers_(model, g)
        init_vit_(model.backbone, g)
    else:
        init_backbone(model, g)
    if backbone_state is not None:
        model.backbone.load_state_dict(backbone_state)
    return model


def apply_classifier_train(model: ImageClassifier, pixels: torch.Tensor) -> torch.Tensor:
    """The train-mode forward (``model.train()`` stays set): a BatchNorm
    backbone normalises with the batch's statistics and updates its running
    ones, torchvision's ``train()``; the JAX counterpart returns the updated
    ``batch_stats``, which the module holds here."""
    return model.train()(pixels)
