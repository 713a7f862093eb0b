"""Architecture modules: everything the harness knows of a model's towers.

A configuration names its module by its ``architecture`` key
(``portbench/arch/<architecture>.py``); a configuration without the key is
``openai_clip``. Nothing else in the harness knows which towers it runs.
A module provides:

- ``KEYS``: the configuration keys the architecture takes (widths,
  depths, switches). A configuration holds each of them and no other key
  than these and :data:`COMMON_KEYS`.
- ``encoder(cfg, precision, W, device, batch_size, fingerprint)``: the
  program's ``ClipEncoder`` around the program's own model class for the
  architecture, in ``precision`` (the program's ``Precision``), loaded with
  the weights ``W``, with the ``tokenize_fn`` the program's registry gives
  that model. It alone may import the program, and only inside the call.
- ``param_shapes(cfg)``: every weight as (name, shape), in the order of the
  draw (the program's state-dict names); ``scale(name, shape, cfg)``: a
  weight's (std, mean). :func:`portbench.weights.make_weights` draws them.
- The plain reference, in ``torch`` alone: ``preprocess(images_u8, cfg)``
  ((B, H, W, C) uint8 to the towers' pixels), ``tokenize(texts, cfg)``
  ((B, context) integer ids, numpy), ``encode_image(W, cfg, pixels, mode)``
  and ``encode_text(W, cfg, tokens, mode)`` (L2-normalised embeddings), in
  each mode of :data:`portbench.reference.operands.MODES`: ``fp32`` judges
  the program, the others stand in for it one precision below.
- FLOPs: ``embed_dim(cfg)`` (the width of the shared space, which the
  searches take), ``image_flops(cfg)``, ``text_flops(cfg, length)`` and
  ``text_lengths(texts, cfg)``: the positions ``detect_mfu`` counts for
  each text.
"""

from __future__ import annotations

import importlib
from types import ModuleType

DEFAULT = "openai_clip"

# keys every configuration may hold, whatever its architecture
COMMON_KEYS = frozenset({"name", "source", "about", "registry", "precision", "reduced", "assumed", "comparison_pairs",
                         "architecture"})


def of(cfg: dict) -> ModuleType:
    """The architecture module of a configuration."""
    return importlib.import_module(f"{__name__}.{cfg.get('architecture', DEFAULT)}")


def key_errors(cfg: dict) -> list:
    """What is wrong with a configuration's keys: each key its architecture
    takes that it lacks, each it holds that no one takes."""
    keys = of(cfg).KEYS
    return ([f"lacks {k!r}" for k in keys if k not in cfg]
            + [f"holds {k!r}, which {cfg.get('architecture', DEFAULT)} does not take"
               for k in sorted(set(cfg) - set(keys) - COMMON_KEYS)])
