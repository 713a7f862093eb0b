"""The weights bridge: JAX parameter trees -> torch state dicts.

Both checkpoint routes meet here. A flax tree (``init_params(cfg, seed)[1]``
in the JAX package, or a ``"/"``-flattened ``.npz`` as
``lemon_tpu/models/registry.py:63-88`` reads it) converts directly; a
HuggingFace, OpenAI or open_clip checkpoint first becomes a flax-layout
tree (:mod:`lemon_tpu_torch.models.loader`, ``biomed``). The tree is a
``ClipModel``'s (a ViT vision tower, or a ModifiedResNet one, whose
``stem_conv1`` marks it) or a ``BiomedClipModel``'s (a BERT text tower,
marked by ``word_embeddings``). Dense kernels are (in, out) in flax and
(out, in) in ``nn.Linear``; conv kernels (kh, kw, in, out) in flax and
(out, in, kh, kw) in ``nn.Conv2d``; everything else keeps its layout. A
tree that the JAX int8 modes quantised (``kernel_q``, ``kernel_scale`` and,
after calibration, ``act_scale`` under the vision projections) fills the
port's ``QuantLinear`` buffers of the same names. A JAX ``ImageClassifier``'s
variables (the CLIP vision tower, the torchvision-layout ResNet-50 with its
``batch_stats``, or the google-ViT, and the head) convert through
:func:`classifier_from_flax`, and the three captioner families (GIT-style,
Q-Former, HF-exact BLIP-2) through :func:`captioner_from_flax`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch


def _linear(prefix: str, node: Mapping) -> Dict[str, np.ndarray]:
    if "kernel_q" not in node:
        out = {f"{prefix}.weight": np.asarray(node["kernel"]).T}
        if "bias" in node:
            out[f"{prefix}.bias"] = np.asarray(node["bias"])
        return out
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


def _batch_norm(prefix: str, node: Mapping) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(node["scale"]), f"{prefix}.bias": np.asarray(node["bias"]),
            f"{prefix}.running_mean": np.asarray(node["mean"]), f"{prefix}.running_var": np.asarray(node["var"])}


def _conv(prefix: str, node: Mapping) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))}


def _vit(v: Mapping) -> Dict[str, np.ndarray]:
    sd = {
        "visual.patch_embed.weight": np.asarray(v["patch_embedding"]).T,
        "visual.class_embedding": np.asarray(v["class_embedding"]),
        "visual.positional_embedding": np.asarray(v["positional_embedding"]),
        **_blocks("visual", v["transformer"]),
        **_layer_norm("visual.ln_post", v["ln_post"]),
    }
    if "proj" in v:  # a captioner's tower has none (tokens only)
        sd["visual.proj"] = np.asarray(v["proj"])
    if "patch_bias" in v:
        sd["visual.patch_bias"] = np.asarray(v["patch_bias"])
    if "ln_pre" in v:
        sd.update(_layer_norm("visual.ln_pre", v["ln_pre"]))
    return sd


def _resnet(v: Mapping) -> Dict[str, np.ndarray]:
    """The ModifiedResNet tree (lemon_tpu/models/resnet.py module names)."""
    sd = {}
    for name, node in v.items():
        if name.startswith("stem_conv"):
            sd.update(_conv(f"visual.{name}", node))
        elif name.startswith("stem_bn"):
            sd.update(_batch_norm(f"visual.{name}", node))
        elif name.startswith("layer"):
            for part, leaf in node.items():
                fn = _conv if "conv" in part else _batch_norm
                sd.update(fn(f"visual.{name}.{part}", leaf))
    pool = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = np.asarray(pool["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd.update(_linear(f"visual.attnpool.{proj}", pool[proj]))
    return sd


def _clip_text(t: Mapping) -> Dict[str, np.ndarray]:
    return {
        "text.token_embedding.weight": np.asarray(t["token_embedding"]),
        "text.positional_embedding": np.asarray(t["positional_embedding"]),
        **_blocks("text", t["transformer"]),
        **_layer_norm("text.ln_final", t["ln_final"]),
        "text.text_projection": np.asarray(t["text_projection"]),
    }


def _bert_text(t: Mapping) -> Dict[str, np.ndarray]:
    """The BERT tower's tree (lemon_tpu/models/bert_text.py module names)."""
    sd = {f"text.{k}": np.asarray(t[k]) for k in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    sd.update(_layer_norm("text.ln_emb", t["ln_emb"]))
    for name, layer in t.items():
        if name.startswith("layer_"):
            p = f"text.layers.{int(name.removeprefix('layer_'))}"
            for part, leaf in layer.items():
                fn = _layer_norm if part.startswith("ln_") else _linear
                sd.update(fn(f"{p}.{part}", leaf))
    for head in ("proj", "proj_fc", "proj_out"):
        if head in t:
            sd.update(_linear(f"text.{head}", t[head]))
    return sd


def from_flax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``ClipModel`` or ``BiomedClipModel`` tree (with or without the
    ``"params"`` level) of numpy-convertible leaves -> a state dict for
    :class:`lemon_tpu_torch.models.clip.ClipModel` or
    :class:`lemon_tpu_torch.models.biomed.BiomedClipModel`: fp32, but the
    int8 ``weight_q`` of a quantised tree."""
    params = tree["params"] if "params" in tree else tree
    v, t = params["visual"], params["text"]
    sd = {
        **(_resnet(v) if "stem_conv1" in v else _vit(v)),
        **(_bert_text(t) if "word_embeddings" in t else _clip_text(t)),
        "logit_scale": np.asarray(params["logit_scale"]),
    }
    return {k: torch.from_numpy(np.array(a, dtype=np.int8 if k.endswith(".weight_q") else np.float32, order="C"))
            for k, a in sd.items()}


def _tv_resnet(params: Mapping, stats: Mapping) -> Dict[str, np.ndarray]:
    """The JAX ``TvResNet50`` tree (``layer{s}_{b}`` blocks, ``downsample_conv``
    / ``downsample_bn``) and its ``batch_stats`` -> torchvision's names."""
    def bn(prefix, p, st):
        return _batch_norm(prefix, {**p, **st})

    sd = {**_conv("conv1", params["conv1"]), **bn("bn1", params["bn1"], stats["bn1"]),
          **_linear("fc", params["fc"])}
    for name, blk in params.items():
        if not name.startswith("layer"):
            continue
        stage, b = name.removeprefix("layer").split("_")
        t = f"layer{stage}.{b}"
        for part, leaf in blk.items():
            torch_part = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(part, part)
            sd.update(_conv(f"{t}.{torch_part}", leaf) if "conv" in part
                      else bn(f"{t}.{torch_part}", leaf, stats[name][part]))
    return sd


def _google_vit(v: Mapping) -> Dict[str, np.ndarray]:
    """The JAX ``GoogleViTEncoder`` tree -> the port's module names (the same)."""
    sd = {"patch_embedding.weight": np.transpose(np.asarray(v["patch_embedding"]["kernel"]), (3, 2, 0, 1)),
          "patch_embedding.bias": np.asarray(v["patch_embedding"]["bias"]),
          "cls_token": np.asarray(v["cls_token"]), "position_embeddings": np.asarray(v["position_embeddings"]),
          **_layer_norm("ln_final", v["ln_final"])}
    for name, blk in v.items():
        if name.startswith("block_"):
            p = f"blocks.{int(name.removeprefix('block_'))}"
            for part, leaf in blk.items():
                sd.update((_layer_norm if part.startswith("ln_") else _linear)(f"{p}.{part}", leaf))
    return sd


def classifier_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``ImageClassifier``'s variables (``params``, plus
    ``batch_stats`` for the ResNet; numpy-convertible leaves) -> a state dict
    for :class:`lemon_tpu_torch.models.classifier.ImageClassifier`, whichever
    of the three backbones it holds. Flax convs (kh, kw, I, O) become
    (O, I, kh, kw), dense kernels are transposed; BatchNorm's
    ``num_batches_tracked``, which JAX has not, is 0."""
    params = variables["params"]
    bb = params["backbone"]
    if "fc" in bb:
        body = _tv_resnet(bb, variables["batch_stats"]["backbone"])
    elif "cls_token" in bb:
        body = _google_vit(bb)
    else:
        body = {k.removeprefix("visual."): a for k, a in _vit(bb).items()}
    sd = {f"backbone.{k}": a for k, a in body.items()}
    sd.update(_linear("head", params["head"]))
    out = {k: torch.from_numpy(np.array(a, dtype=np.float32, order="C")) for k, a in sd.items()}
    for k in [k for k in out if k.endswith(".running_var")]:
        out[k.replace(".running_var", ".num_batches_tracked")] = torch.tensor(0)
    return out


_BLOCK_NAMES = ((r"^(?:block|lm_block|opt_block)_(\d+)$", r"blocks.\1"), (r"^qformer_block_(\d+)$", r"qformer_blocks.\1"))


def _flax_module_names(node: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """A flax subtree under the port's module names: ``block_{i}``-style
    lists become ``blocks.{i}``, a dense kernel (in, out) a transposed
    ``weight``, a conv kernel (kh, kw, in, out) an (out, in, kh, kw)
    ``weight``, a LayerNorm ``scale`` a ``weight``; every other leaf (biases,
    embeddings, LoRA factors, laid out alike) keeps its name."""
    import re

    out = {}
    for key, val in node.items():
        name = key
        for pattern, repl in _BLOCK_NAMES:
            name = re.sub(pattern, repl, name)
        path = f"{prefix}.{name}" if prefix else name
        if isinstance(val, Mapping):
            out.update(_flax_module_names(val, path))
            continue
        a = np.asarray(val)
        if key == "kernel":
            a, path = (a.T if a.ndim == 2 else np.transpose(a, (3, 2, 0, 1))), f"{prefix}.weight"
        elif key == "scale":
            path = f"{prefix}.weight"
        out[path] = a
    return out


def captioner_from_flax(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A JAX captioner's parameters (``init_captioner(cfg)[1]`` or
    ``load_blip2``'s, with or without the ``"params"`` level) -> the state
    dict of the port's model of the same config: ``CaptioningModel``,
    ``QFormerCaptioner`` (their CLIP tower as :func:`from_flax_params`
    converts it) or ``Blip2Captioner`` (its ViT-g by module name), fp32."""
    from lemon_tpu_torch.models.blip2 import Blip2Config

    params = tree["params"] if "params" in tree else tree
    sd = {}
    for name, node in params.items():
        if name == "visual" and not isinstance(cfg, Blip2Config):
            sd.update(_vit(node))
        else:
            sd.update(_flax_module_names({name: node}, ""))
    return {k: torch.from_numpy(np.array(a, dtype=np.float32, order="C")) for k, a in sd.items()}


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
