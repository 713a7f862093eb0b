"""CLIP weights made from the seed, on the device, in one draw.

One ``torch.randn`` over every weight's elements at once, from a generator
on the device seeded from ``--seed``; each weight is then a scaled slice of
it: projections ``N(0, 1/fan_in)``, biases ``N(0, 0.02^2)``, LayerNorm
gains ``1 + N(0, 0.05^2)`` and offsets ``N(0, 0.02^2)``, the class and
vision position embeddings ``N(0, 1/width)``, the token embedding
``N(0, 0.02^2)``, the text positions ``N(0, 0.01^2)``. fp32, as both the
program and the reference are handed them; the program casts what it
serves in a lower precision itself. The same seed gives the same weights,
so the reference makes them again after the window instead of keeping a
second copy on the card through it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference.clip import param_shapes


def torch_seed(*parts: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from any whole numbers."""
    words = [int(p) & 0xFFFFFFFFFFFFFFFF for p in parts]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def _scale(name: str, shape, cfg: dict):
    """(std, mean) of a weight."""
    if name == "logit_scale":
        return 0.0, math.log(1 / 0.07)
    if name.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight", "ln_post.weight", "ln_final.weight")):
        return 0.05, 1.0
    if name.endswith(".bias"):
        return 0.02, 0.0
    if name in ("visual.class_embedding", "visual.positional_embedding"):
        return cfg["vision_width"] ** -0.5, 0.0
    if name == "text.token_embedding.weight":
        return 0.02, 0.0
    if name == "text.positional_embedding":
        return 0.01, 0.0
    if name in ("visual.proj", "text.text_projection"):  # (in, out)
        return shape[0] ** -0.5, 0.0
    return shape[1] ** -0.5, 0.0  # (out, in) projections


def make_weights(cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, offset = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        std, mean = _scale(name, shape, cfg)
        out[name] = flat[offset: offset + n].view(shape).mul_(std).add_(mean)
        offset += n
    return out
