"""Weights made from the seed, on the device, in one draw.

One ``torch.randn`` over every weight's elements at once, from a generator
on the device seeded from ``--seed``; each weight is then a slice of it,
scaled to the (std, mean) that the configuration's architecture module
gives it (:mod:`portbench.arch`: ``param_shapes``, ``scale``). fp32, as
both the program and the reference are handed them; the program casts what
it serves in a lower precision itself. The same seed gives the same
weights, so the reference makes them again after the window instead of
keeping a second copy on the card through it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench import arch


def torch_seed(*parts: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from any whole numbers."""
    words = [int(p) & 0xFFFFFFFFFFFFFFFF for p in parts]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def make_weights(cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    model = arch.of(cfg)
    shapes = model.param_shapes(cfg)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, offset = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        std, mean = model.scale(name, shape, cfg)
        out[name] = flat[offset: offset + n].view(shape).mul_(std).add_(mean)
        offset += n
    return out
