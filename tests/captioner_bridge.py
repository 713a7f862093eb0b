"""Shared by the captioner tests: one JAX captioner init, and the port's model
of the same config holding the same weights (``captioner_from_flax``)."""

import dataclasses

import jax
import numpy as np
import torch


def port_config(jax_cfg):
    """The port's config of the same type and fields as a JAX captioner
    config (the JAX ``attention_impl`` 'xla' is the port's 'plain')."""
    from lemon_tpu_torch.models.blip2 import Blip2Config
    from lemon_tpu_torch.models.captioner import CaptionerConfig
    from lemon_tpu_torch.models.clip import ClipConfig
    from lemon_tpu_torch.models.qformer import QFormerConfig

    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    v = jax_cfg.vision
    fields["vision"] = ClipConfig(**{f.name: getattr(v, f.name) for f in dataclasses.fields(ClipConfig)
                                     if f.name != "attention_impl"})
    cls = {"CaptionerConfig": CaptionerConfig, "QFormerConfig": QFormerConfig,
           "Blip2Config": Blip2Config}[type(jax_cfg).__name__]
    return cls(**fields)


def nudge_lora(params, by: float = 0.05):
    """LoRA B starts at zero; a shift makes the adapters change the output."""
    return jax.tree_util.tree_map_with_path(lambda p, x: x + by if "lora_b" in jax.tree_util.keystr(p) else x, params)


def port_model(params, jax_cfg):
    from lemon_tpu_torch.models.captioner import init_captioner
    from lemon_tpu_torch.models.convert import captioner_from_flax

    cfg = port_config(jax_cfg)
    model = init_captioner(cfg, 0, torch.device("cpu"))
    model.load_state_dict(captioner_from_flax(params, cfg))
    return model.eval()


def agree_under_margin(jax_tokens: np.ndarray, port_tokens: np.ndarray, margins: np.ndarray, eps: float = 1e-4):
    """Greedy tokens agree row by row up to the first step whose top-2 logit
    margin (of the port's logits at that step) is within ``eps``: a near-tie
    may break either way between packages. Returns the steps compared."""
    compared = 0
    for r in range(len(jax_tokens)):
        for t in range(margins.shape[1]):
            if margins[r, t] <= eps:
                break
            assert jax_tokens[r, t + 1] == port_tokens[r, t + 1], (r, t)
            compared += 1
    return compared
