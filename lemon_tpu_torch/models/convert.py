"""The weights bridge: JAX ``ClipModel`` parameter trees -> torch state dicts.

Both checkpoint routes meet here. A flax tree (``init_params(cfg, seed)[1]``
in the JAX package, or a ``"/"``-flattened ``.npz`` as
``lemon_tpu/models/registry.py:63-88`` reads it) converts directly; a
HuggingFace checkpoint first becomes a flax-layout tree in
:mod:`lemon_tpu_torch.models.loader`. Dense kernels are (in, out) in flax
and (out, in) in ``nn.Linear``; everything else keeps its layout. A tree
that the JAX int8 modes quantised (``kernel_q``, ``kernel_scale`` and, after
calibration, ``act_scale`` under the vision projections) fills the port's
``QuantLinear`` buffers of the same names.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch


def _linear(prefix: str, node: Mapping) -> Dict[str, np.ndarray]:
    if "kernel_q" not in node:
        return {f"{prefix}.weight": np.asarray(node["kernel"]).T, f"{prefix}.bias": np.asarray(node["bias"])}
    out = {f"{prefix}.weight_q": np.asarray(node["kernel_q"]).T, f"{prefix}.weight_scale": np.asarray(node["kernel_scale"]),
           f"{prefix}.bias": np.asarray(node["bias"])}
    if "act_scale" in node:
        out[f"{prefix}.act_scale"] = np.asarray(node["act_scale"])
    return out


def _layer_norm(prefix: str, node: Mapping) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(node["scale"]), f"{prefix}.bias": np.asarray(node["bias"])}


def _blocks(prefix: str, transformer: Mapping) -> Dict[str, np.ndarray]:
    out = {}
    for name, blk in transformer.items():
        i = int(name.removeprefix("block_"))
        p = f"{prefix}.blocks.{i}"
        out.update(_layer_norm(f"{p}.ln_1", blk["ln_1"]))
        out.update(_layer_norm(f"{p}.ln_2", blk["ln_2"]))
        out.update(_linear(f"{p}.attn.qkv", blk["attn"]["qkv"]))
        out.update(_linear(f"{p}.attn.out", blk["attn"]["out"]))
        out.update(_linear(f"{p}.mlp_fc", blk["mlp_fc"]))
        out.update(_linear(f"{p}.mlp_proj", blk["mlp_proj"]))
    return out


def from_flax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``ClipModel`` tree (with or without the ``"params"`` level) of
    numpy-convertible leaves -> a state dict for
    :class:`lemon_tpu_torch.models.clip.ClipModel`: fp32, but the int8
    ``weight_q`` of a quantised tree."""
    params = tree["params"] if "params" in tree else tree
    v, t = params["visual"], params["text"]
    sd = {
        "visual.patch_embed.weight": np.asarray(v["patch_embedding"]).T,
        "visual.class_embedding": np.asarray(v["class_embedding"]),
        "visual.positional_embedding": np.asarray(v["positional_embedding"]),
        **_layer_norm("visual.ln_pre", v["ln_pre"]),
        **_blocks("visual", v["transformer"]),
        **_layer_norm("visual.ln_post", v["ln_post"]),
        "visual.proj": np.asarray(v["proj"]),
        "text.token_embedding.weight": np.asarray(t["token_embedding"]),
        "text.positional_embedding": np.asarray(t["positional_embedding"]),
        **_blocks("text", t["transformer"]),
        **_layer_norm("text.ln_final", t["ln_final"]),
        "text.text_projection": np.asarray(t["text_projection"]),
        "logit_scale": np.asarray(params["logit_scale"]),
    }
    return {k: torch.from_numpy(np.array(a, dtype=np.int8 if k.endswith(".weight_q") else np.float32, order="C"))
            for k, a in sd.items()}


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """``{"params/visual/proj": array, ...}`` -> the nested tree."""
    out: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def load_flax_npz(path) -> dict:
    """Read a ``"/"``-flattened ``.npz`` of a JAX parameter tree."""
    with np.load(Path(path)) as blob:
        return unflatten({k: blob[k] for k in blob.files})
