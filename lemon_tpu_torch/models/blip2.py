"""The HF-exact BLIP-2 captioner with the OPT decoder (port of
lemon_tpu/models/blip2.py; reference lib/models/utils.py:27-46,
downstream_captioning.py:92,216-224).

Activation for activation ``Blip2ForConditionalGeneration`` with an OPT LM:

- **vision**: BLIP-2's ViT (:class:`lemon_tpu_torch.models.blip_itm.BlipVisionTower`,
  eps 1e-6): conv patch embedding with bias, class token, positions, no
  pre-LN, pre-LN blocks with a fused ``qkv`` and exact GELU,
  ``post_layernorm``; detached (BLIP-2 freezes its image encoder);
- **Q-Former**: an input LayerNorm (eps 1e-12) over the learned queries,
  then post-LN BERT blocks (:class:`Blip2QFormerBlock`): self-attention,
  cross-attention into the image tokens every ``cross_attention_freq``
  layers, the query-path MLP (``intermediate_query``/``output_query``);
- **OPT**: learned positions with the +2 offset, pre-LN blocks
  (:class:`OptBlock`, ReLU MLP, LoRA on ``q_proj``/``k_proj`` only), causal
  over the whole [queries, text] sequence (not the prefix-LM mask), a final
  LayerNorm and logits tied to ``embed_tokens`` (no ``lm_head``).

``generate_judged`` is the judge backends' prompt-conditioned greedy loop:
left-padded prompts, OPT's cumsum positions over the attention mask, the
chosen token's log-probability each step (:490-527).

:func:`load_blip2` reads a local ``save_pretrained`` directory without
``transformers``: ``config.json`` through :func:`blip2_config_from_hf`
(HF's ``Blip2Config``/``OPTConfig`` defaults for every omitted key), the
weights through :func:`safetensors_io.load_pretrained` (one file or an
index and its shards, safetensors or ``torch.save``), and checks every
non-LoRA parameter's name and shape (:484-499). :func:`save_blip2` writes
such a directory, sharded above ``max_shard_bytes`` as HF shards it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.models.blip_itm import VISION_NAMES, BlipVisionTower, rename, unbatch
from lemon_tpu_torch.models.captioner import CaptionerConfig, CaptioningModel, LoraLinear, init_captioner
from lemon_tpu_torch.models.clip import ClipConfig, FpLayerNorm, attend
from lemon_tpu_torch.models.safetensors_io import load_pretrained, save_sharded

QFORMER_EPS = 1e-12
VISION_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Blip2Config(CaptionerConfig):
    """``vision`` carries the ViT's dims, ``decoder_*`` OPT's, ``qformer_*``
    the Q-Former's; ``*_mlp_dim = 0`` means 4x the width."""

    vision_mlp_dim: int = 0
    n_queries: int = 32
    qformer_width: int = 768
    qformer_layers: int = 12
    qformer_heads: int = 12
    qformer_mlp_dim: int = 0
    cross_attention_freq: int = 2
    decoder_mlp_dim: int = 0
    max_positions: int = 0  # OPT's position rows minus the +2 offset; 0 = max_text_len + n_queries
    freeze_vision: bool = True  # BLIP-2's image encoder is always frozen

    @property
    def n_image_tokens(self) -> int:
        return self.n_queries

    @staticmethod
    def tiny() -> "Blip2Config":
        return Blip2Config(
            vision=ClipConfig(image_resolution=56, vision_width=32, vision_layers=2, vision_heads=2,
                              vision_patch_size=14),
            vocab_size=120, decoder_width=32, decoder_layers=2, decoder_heads=2, max_text_len=16, n_queries=4,
            qformer_width=32, qformer_layers=2, qformer_heads=2, pad_token_id=1, bos_token_id=2, eos_token_id=2,
        )

    @staticmethod
    def opt_2_7b() -> "Blip2Config":
        """``Salesforce/blip2-opt-2.7b``'s published widths: ViT-g (1408 wide,
        39 layers, 16 heads, MLP 6144, 224 px in 14 px patches), the Q-Former
        (768 wide, 12 layers, cross-attention every 2nd, 32 queries) and
        OPT-2.7B (2560 wide, 32 layers, 32 heads, FFN 10240, vocab 50272,
        2048 positions)."""
        return Blip2Config(
            vision=ClipConfig(image_resolution=224, vision_width=1408, vision_layers=39, vision_heads=16,
                              vision_patch_size=14),
            vision_mlp_dim=6144, n_queries=32, qformer_width=768, qformer_layers=12, qformer_heads=12,
            qformer_mlp_dim=3072, cross_attention_freq=2, vocab_size=50272, decoder_width=2560,
            decoder_layers=32, decoder_heads=32, decoder_mlp_dim=10240, max_positions=2048,
            max_text_len=40, lora_rank=16, pad_token_id=1, bos_token_id=2, eos_token_id=2,
        )


class Blip2QFormerBlock(nn.Module):
    """Post-LN BERT block over the queries (the query path's MLP)."""

    def __init__(self, width: int, heads: int, mlp_dim: int, has_cross: bool, image_width: int):
        super().__init__()
        self.heads = heads
        self.has_cross = has_cross
        self.self_query, self.self_key, self.self_value = (nn.Linear(width, width) for _ in range(3))
        self.self_out = nn.Linear(width, width)
        self.ln_self = FpLayerNorm(width, eps=QFORMER_EPS)
        if has_cross:
            self.cross_query = nn.Linear(width, width)
            self.cross_key, self.cross_value = nn.Linear(image_width, width), nn.Linear(image_width, width)
            self.cross_out = nn.Linear(width, width)
            self.ln_cross = FpLayerNorm(width, eps=QFORMER_EPS)
        self.intermediate_query = nn.Linear(width, mlp_dim)
        self.output_query = nn.Linear(mlp_dim, width)
        self.ln_output = FpLayerNorm(width, eps=QFORMER_EPS)

    def forward(self, x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        att = self.self_out(attend(self.self_query(x), self.self_key(x), self.self_value(x), self.heads))
        x = self.ln_self(att + x)
        if self.has_cross:
            att = self.cross_out(attend(self.cross_query(x), self.cross_key(img), self.cross_value(img), self.heads))
            x = self.ln_cross(att + x)
        y = self.output_query(F.gelu(self.intermediate_query(x)))
        return self.ln_output(y + x)


class OptBlock(nn.Module):
    """Pre-LN OPT decoder layer: LoRA on ``q_proj``/``k_proj``, ReLU MLP."""

    def __init__(self, width: int, heads: int, mlp_dim: int, lora_rank: int = 0):
        super().__init__()
        self.heads = heads
        self.self_attn_layer_norm = FpLayerNorm(width)
        self.q_proj = LoraLinear(width, width, lora_rank)
        self.k_proj = LoraLinear(width, width, lora_rank)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)
        self.final_layer_norm = FpLayerNorm(width)
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = self.self_attn_layer_norm(x)
        x = x + self.out_proj(attend(self.q_proj(y), self.k_proj(y), self.v_proj(y), self.heads, mask))
        return x + self.fc2(F.relu(self.fc1(self.final_layer_norm(x))))


class Blip2Captioner(CaptioningModel):
    """``forward``/``per_sample_loss``/``generate`` are
    :class:`CaptioningModel`'s; the towers and ``_decode`` are BLIP-2's."""

    def _build(self, c: Blip2Config) -> None:
        v = c.vision
        self.visual = BlipVisionTower(v.vision_width, v.vision_layers, v.v_heads, c.vision_mlp_dim or 4 * v.vision_width,
                                      v.image_resolution, v.vision_patch_size, VISION_EPS)
        self.query_tokens = nn.Parameter(torch.empty(c.n_queries, c.qformer_width))
        self.qformer_input_ln = FpLayerNorm(c.qformer_width, eps=QFORMER_EPS)
        self.qformer_blocks = nn.ModuleList(
            Blip2QFormerBlock(c.qformer_width, c.qformer_heads, c.qformer_mlp_dim or 4 * c.qformer_width,
                              i % c.cross_attention_freq == 0, v.vision_width)
            for i in range(c.qformer_layers))
        self.language_projection = nn.Linear(c.qformer_width, c.decoder_width)
        self.embed_tokens = nn.Parameter(torch.empty(c.vocab_size, c.decoder_width))
        n_pos = (c.max_positions or (c.max_text_len + c.n_queries)) + 2  # OPT's offset rows
        self.embed_positions = nn.Parameter(torch.empty(n_pos, c.decoder_width))
        self.blocks = nn.ModuleList(
            OptBlock(c.decoder_width, c.decoder_heads, c.decoder_mlp_dim or 4 * c.decoder_width, c.lora_rank)
            for _ in range(c.decoder_layers))
        self.ln_final = FpLayerNorm(c.decoder_width)

    def init_embeddings_(self, g: torch.Generator) -> None:
        """Every embedding N(0, 0.02), as the JAX initialisers."""
        for p in (self.visual.class_embedding, self.visual.position_embedding, self.query_tokens, self.embed_tokens,
                  self.embed_positions):
            p.normal_(0.0, 0.02, generator=g)

    def encode_image_prefix(self, pixels: torch.Tensor) -> torch.Tensor:
        img = self.visual(pixels).detach()  # BLIP-2 freezes its image encoder
        x = self.qformer_input_ln(self.query_tokens.expand(pixels.shape[0], -1, -1))
        for block in self.qformer_blocks:
            x = block(x, img)
        return self.language_projection(x)

    def _decode(self, image_tokens: torch.Tensor, text_tokens: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """OPT over [projected queries, text]: causal over the whole sequence,
        positions from row 2 on, logits tied to ``embed_tokens``.
        ``key_mask`` (B, L_txt), true at valid text positions (left-padded
        prompts): padded keys are masked out and positions are OPT's
        ``cumsum(mask) * mask - 1``, + 2. None: contiguous positions."""
        n_img, l_txt = image_tokens.shape[1], text_tokens.shape[1]
        x = torch.cat([image_tokens, self.embed_tokens[text_tokens]], dim=1)
        pos = torch.arange(n_img + l_txt, device=x.device)
        causal = torch.where(pos[None, :] <= pos[:, None], 0.0, -math.inf)[None, None]
        if key_mask is None:
            x = x + self.embed_positions[2 : n_img + l_txt + 2]
            mask = causal
        else:
            full = torch.cat([torch.ones(key_mask.shape[0], n_img, dtype=torch.long, device=x.device),
                              key_mask.long()], dim=1)
            pos_ids = (torch.cumsum(full, dim=1) * full - 1) * full + 2
            x = x + self.embed_positions[pos_ids]
            mask = causal + torch.where(full.bool(), 0.0, -math.inf)[:, None, None, :]
        for block in self.blocks:
            x = block(x, mask)
        return (self.ln_final(x) @ self.embed_tokens.T)[:, n_img:]

    @torch.no_grad()
    def generate_judged(self, pixels: torch.Tensor, prompt_tokens: torch.Tensor, prompt_mask: torch.Tensor,
                        max_new_tokens: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
        """Greedy generation after LEFT-padded prompts (each row's last prompt
        token abuts its first generated position): (tokens (B, T), log
        P(chosen) (B, T)), 0 and the pad id after a row's EOS; the HF
        backend's ``compute_transition_scores`` semantics."""
        c: Blip2Config = self.cfg
        prefix = self.encode_image_prefix(pixels)
        b, lp = prompt_tokens.shape
        dev = prefix.device
        text = torch.cat([prompt_tokens.long(), torch.full((b, max_new_tokens), c.pad_token_id, device=dev)], dim=1)
        key_mask = torch.cat([prompt_mask.long(), torch.zeros(b, max_new_tokens, dtype=torch.long, device=dev)], dim=1)
        logprobs = torch.zeros(b, max_new_tokens, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        for t in range(max_new_tokens):
            step_logits = self._decode(prefix, text, key_mask=key_mask)[:, lp + t - 1].float()
            nxt = step_logits.argmax(dim=-1)
            chosen = torch.log_softmax(step_logits, dim=-1).gather(1, nxt[:, None])[:, 0]
            nxt = torch.where(done, c.pad_token_id, nxt)
            text[:, lp + t] = nxt
            key_mask[:, lp + t] = (~done).long()
            logprobs[:, t] = torch.where(done, 0.0, chosen)
            done = done | (nxt == c.eos_token_id)
        return text[:, lp:], logprobs


# ---------------------------------------------------------------------------
# HF checkpoints


def blip2_config_from_hf(hf: Mapping, lora_rank: int = 0, max_text_len: int = 40) -> Blip2Config:
    """A parsed ``config.json`` of ``Blip2ForConditionalGeneration`` with an
    OPT LM -> :class:`Blip2Config`; every omitted key takes HF's default
    (``Blip2VisionConfig``, ``Blip2QFormerConfig``, ``OPTConfig``). The three
    JAX asserts (:352-354) raise ``ValueError`` here."""
    if hf.get("model_type", "blip-2") != "blip-2":
        raise ValueError(f"model_type {hf['model_type']!r} is not modelled (want 'blip-2')")
    v, q, t = (dict(hf.get(k) or {}) for k in ("vision_config", "qformer_config", "text_config"))
    if t.get("model_type", "opt") != "opt":
        raise ValueError(f"text model_type {t['model_type']!r} is not modelled (only OPT, as blip2-opt-2.7b)")
    width = t.get("hidden_size", 768)
    if t.get("word_embed_proj_dim") not in (None, width):
        raise ValueError("OPT's project_in/project_out (word_embed_proj_dim != hidden_size) is not modelled")
    if not t.get("do_layer_norm_before", True):
        raise ValueError("post-LN OPT (do_layer_norm_before=False) is not modelled")
    for part, sub, act in (("vision", v, "hidden_act"), ("qformer", q, "hidden_act"), ("text", t, "activation_function")):
        want = "relu" if part == "text" else "gelu"
        if sub.get(act, want) != want:
            raise ValueError(f"{part} {act} {sub[act]!r} is not modelled (want {want!r})")
    return Blip2Config(
        vision=ClipConfig(image_resolution=v.get("image_size", 224), vision_width=v.get("hidden_size", 1408),
                          vision_layers=v.get("num_hidden_layers", 39), vision_heads=v.get("num_attention_heads", 16),
                          vision_patch_size=v.get("patch_size", 14)),
        vision_mlp_dim=v.get("intermediate_size", 6144),
        n_queries=hf.get("num_query_tokens", 32),
        qformer_width=q.get("hidden_size", 768), qformer_layers=q.get("num_hidden_layers", 12),
        qformer_heads=q.get("num_attention_heads", 12), qformer_mlp_dim=q.get("intermediate_size", 3072),
        cross_attention_freq=q.get("cross_attention_frequency", 2),
        vocab_size=t.get("vocab_size", 50272), decoder_width=width, decoder_layers=t.get("num_hidden_layers", 12),
        decoder_heads=t.get("num_attention_heads", 12), decoder_mlp_dim=t.get("ffn_dim", 3072),
        max_positions=t.get("max_position_embeddings", 2048), max_text_len=max_text_len, lora_rank=lora_rank,
        pad_token_id=t.get("pad_token_id", 1), bos_token_id=t.get("bos_token_id", 2),
        eos_token_id=t.get("eos_token_id", 2),
    )


_Q = "qformer.encoder.layer.{i}."
_D = "language_model.model.decoder."
# (HF name, port name) prefixes; HF tensors that match none (the Q-Former's
# text path and word embeddings, the tied lm_head) captioning never runs
_BLIP2_NAMES = tuple((hf, port.replace("{v}", "visual")) for hf, port in VISION_NAMES) + (
    ("query_tokens", "query_tokens"),
    ("qformer.layernorm.", "qformer_input_ln."),
    *((f"{_Q}attention.attention.{n}.", f"qformer_blocks.{{i}}.self_{n}.") for n in ("query", "key", "value")),
    (_Q + "attention.output.dense.", "qformer_blocks.{i}.self_out."),
    (_Q + "attention.output.LayerNorm.", "qformer_blocks.{i}.ln_self."),
    *((f"{_Q}crossattention.attention.{n}.", f"qformer_blocks.{{i}}.cross_{n}.") for n in ("query", "key", "value")),
    (_Q + "crossattention.output.dense.", "qformer_blocks.{i}.cross_out."),
    (_Q + "crossattention.output.LayerNorm.", "qformer_blocks.{i}.ln_cross."),
    (_Q + "intermediate_query.dense.", "qformer_blocks.{i}.intermediate_query."),
    (_Q + "output_query.dense.", "qformer_blocks.{i}.output_query."),
    (_Q + "output_query.LayerNorm.", "qformer_blocks.{i}.ln_output."),
    ("language_projection.", "language_projection."),
    (_D + "embed_tokens.weight", "embed_tokens"),
    (_D + "embed_positions.weight", "embed_positions"),
    (_D + "final_layer_norm.", "ln_final."),
    *((f"{_D}layers.{{i}}.self_attn.{n}.", f"blocks.{{i}}.{n}.") for n in ("q_proj", "k_proj", "v_proj", "out_proj")),
    *((f"{_D}layers.{{i}}.{n}.", f"blocks.{{i}}.{n}.") for n in ("self_attn_layer_norm", "final_layer_norm", "fc1",
                                                                  "fc2")),
)


def convert_blip2_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ``Blip2ForConditionalGeneration`` state dict -> the port's names
    (:374-455), HF's leading batch axes of the class token, the positions
    and the query tokens dropped. LoRA factors are not in a checkpoint: they
    keep their init."""
    out = {}
    for name, t in sd.items():
        new = rename(name, _BLIP2_NAMES)
        if new is not None:
            out[new] = unbatch(new, t)
    return out


def load_blip2(checkpoint_dir, lora_rank: int = 0, max_text_len: int = 40, seed: int = 0,
               device: Optional[torch.device] = None) -> tuple[Blip2Captioner, Blip2Config]:
    """A local HF BLIP-2 (OPT) directory -> (model on ``device``, config).
    ``device=None`` is the CUDA card, and raises without one before anything
    is read: pass ``torch.device("cpu")`` to load on the CPU. Every non-LoRA
    parameter must come from the checkpoint with its shape, and the
    checkpoint may name none the model lacks; the LoRA factors keep their
    init (B = 0: the adapters start as the identity)."""
    device = resolve_device("cuda") if device is None else device
    d = Path(checkpoint_dir)
    cfg = blip2_config_from_hf(json.loads((d / "config.json").read_text()), lora_rank=lora_rank,
                               max_text_len=max_text_len)
    converted = convert_blip2_state_dict(load_pretrained(d))
    model = init_captioner(cfg, seed, device)
    params = dict(model.named_parameters())
    unknown = sorted(set(converted) - set(params))
    if unknown:
        raise KeyError(f"the converter produced names the model lacks: {unknown[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if name.endswith(("lora_a", "lora_b")):
                continue
            if name not in converted:
                raise KeyError(f"{d}: the checkpoint has no {name}")
            if tuple(converted[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(converted[name].shape)}, model {tuple(p.shape)}")
            p.copy_(converted[name])  # casts a half-precision checkpoint to the model's dtype
    return model, cfg


def blip2_hf_config(cfg: Blip2Config) -> dict:
    """``config.json`` of ``Blip2ForConditionalGeneration`` with an OPT LM,
    every size :func:`blip2_config_from_hf` reads written out."""
    v = cfg.vision
    return {
        "architectures": ["Blip2ForConditionalGeneration"], "model_type": "blip-2",
        "num_query_tokens": cfg.n_queries, "use_decoder_only_language_model": True,
        "vision_config": {"model_type": "blip_2_vision_model", "hidden_size": v.vision_width,
                          "intermediate_size": cfg.vision_mlp_dim or 4 * v.vision_width,
                          "num_hidden_layers": v.vision_layers, "num_attention_heads": v.v_heads,
                          "image_size": v.image_resolution, "patch_size": v.vision_patch_size,
                          "layer_norm_eps": VISION_EPS, "hidden_act": "gelu", "qkv_bias": True},
        "qformer_config": {"model_type": "blip_2_qformer", "hidden_size": cfg.qformer_width,
                           "num_hidden_layers": cfg.qformer_layers, "num_attention_heads": cfg.qformer_heads,
                           "intermediate_size": cfg.qformer_mlp_dim or 4 * cfg.qformer_width,
                           "cross_attention_frequency": cfg.cross_attention_freq,
                           "encoder_hidden_size": v.vision_width, "layer_norm_eps": QFORMER_EPS,
                           "hidden_act": "gelu"},
        "text_config": {"model_type": "opt", "vocab_size": cfg.vocab_size, "hidden_size": cfg.decoder_width,
                        "word_embed_proj_dim": cfg.decoder_width, "num_hidden_layers": cfg.decoder_layers,
                        "num_attention_heads": cfg.decoder_heads,
                        "ffn_dim": cfg.decoder_mlp_dim or 4 * cfg.decoder_width,
                        "max_position_embeddings": cfg.max_positions or (cfg.max_text_len + cfg.n_queries),
                        "activation_function": "relu", "do_layer_norm_before": True,
                        "pad_token_id": cfg.pad_token_id, "bos_token_id": cfg.bos_token_id,
                        "eos_token_id": cfg.eos_token_id, "tie_word_embeddings": True},
    }


def blip2_to_hf_state_dict(model: Blip2Captioner) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_blip2_state_dict`: HF's names and batch
    axes (the LoRA factors, which no checkpoint holds, left out; the tied
    ``lm_head`` left out, as ``save_pretrained`` leaves it)."""
    out = {}
    for name, t in model.state_dict().items():
        if name.endswith(("lora_a", "lora_b")):
            continue
        hf = rename(name, _BLIP2_NAMES, reverse=True)
        if hf is None:
            raise KeyError(f"no HF name for {name}")
        if name.endswith("class_embedding"):
            t = t[None, None]
        elif name.endswith(("position_embedding", "query_tokens")):
            t = t[None]
        out[hf] = t
    return out


def save_blip2(model: Blip2Captioner, out_dir, max_shard_bytes: int = 5 * 10**9) -> list:
    """Write ``model`` as a ``save_pretrained`` directory that
    :func:`load_blip2` (and HF's loader) reads: ``config.json`` and the
    weights in the model's dtype through the port's safetensors writer, as
    shards and an index when they exceed ``max_shard_bytes`` (HF's default
    ``max_shard_size`` is 5 GB). Returns the files written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(blip2_hf_config(model.cfg), indent=2))
    return [out / "config.json"] + save_sharded(blip2_to_hf_state_dict(model), out, max_shard_bytes,
                                               metadata={"format": "pt"})
