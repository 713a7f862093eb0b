"""The BLIP image-text-matching tower, in plain PyTorch.

What ``lemon_tpu/baselines/capfilt.py:hf_blip_itm_scorer`` loads through
``transformers`` (``BlipForImageTextRetrieval``, the
``Salesforce/blip-itm-base-coco`` role; reference
lib/baselines/run_capfilt_baseline.py:35-70), re-stated for the GPU machine,
which has no ``transformers``:

- **vision** (:class:`BlipVisionTower`, shared with BLIP-2's tower in
  :mod:`lemon_tpu_torch.models.blip2`): a conv patch embedding with bias, a
  class token and absolute positions, no pre-LN; pre-LN blocks (fused
  ``qkv``, ``projection``, ``fc1``, exact GELU, ``fc2``) at eps
  ``layer_norm_eps``; ``post_layernorm`` over every token;
- **text**: BLIP's BERT encoder with cross-attention into the image tokens
  in every layer (:class:`lemon_tpu_torch.models.bert_text.BlipTextEncoder`),
  every image token attended to (``modeling_blip.py:1265``);
- **head**: ``itm_head``, ``Linear(hidden, 2)`` on token 0
  (``modeling_blip.py:1277``); P(match) is ``softmax(logits)[:, 1]``.

The processor follows ``BlipImageProcessor`` (a squash resize to
``preprocessor_config.json``'s size with PIL on uint8, ``x * rescale_factor``
in float64 cast to float32, then ``(x - mean) / std`` in float32) and
``BertTokenizerFast`` with ``padding=True, truncation=True``
(:class:`lemon_tpu_torch.models.wordpiece.WordPieceTokenizer` over the
directory's ``vocab.txt`` and ``tokenizer_config.json``).

:func:`load_blip_itm` reads a ``save_pretrained`` directory: ``config.json``
(which omits every key at HF's default, so the defaults of ``BlipConfig``,
``BlipTextConfig`` and ``BlipVisionConfig`` are carried here),
``model.safetensors`` (through :mod:`safetensors_io`) or
``pytorch_model.bin``, ``vocab.txt`` and ``preprocessor_config.json``.
:func:`save_blip_itm` writes such a directory from a model of the port.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lemon_tpu_torch.models.bert_text import BertTextConfig, BlipTextEncoder
from lemon_tpu_torch.models.clip import attend
from lemon_tpu_torch.models.safetensors_io import load_file, save_file
from lemon_tpu_torch.models.wordpiece import WordPieceTokenizer
from lemon_tpu_torch.ops.image import CLIP_MEAN, CLIP_STD

RESCALE = 1 / 255  # BlipImageProcessor's rescale_factor default


@dataclasses.dataclass(frozen=True)
class BlipVisionConfig:
    """``BlipVisionConfig``'s defaults: BLIP-base's ViT-B/16 at 384 px."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 384
    patch_size: int = 16
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class BlipItmConfig:
    vision: BlipVisionConfig = dataclasses.field(default_factory=BlipVisionConfig)
    text: BertTextConfig = dataclasses.field(default_factory=lambda: blip_text_config())

    @staticmethod
    def base() -> "BlipItmConfig":
        """``Salesforce/blip-itm-base-coco``'s published widths: ViT-B/16 at
        384 px; BERT-base (12 heads) with cross-attention, vocab 30524."""
        return BlipItmConfig(text=blip_text_config(num_heads=12))

    @staticmethod
    def tiny() -> "BlipItmConfig":
        return BlipItmConfig(
            vision=BlipVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, image_size=32,
                                    patch_size=8),
            text=blip_text_config(vocab_size=60, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                                  max_position_embeddings=64, encoder_hidden_size=32),
        )


def blip_text_config(**kw) -> BertTextConfig:
    """``BlipTextConfig``'s defaults as a :class:`BertTextConfig` with
    cross-attention (note HF's default of 8 heads)."""
    base = dict(vocab_size=30524, hidden_size=768, num_layers=12, num_heads=8, intermediate_size=3072,
                max_position_embeddings=512, type_vocab_size=0, layer_norm_eps=1e-12, cross_attention=True,
                encoder_hidden_size=768)
    return BertTextConfig(**{**base, **kw})


class BlipVisionBlock(nn.Module):
    """Pre-LN ViT block of BLIP and BLIP-2 (``BlipEncoderLayer``)."""

    def __init__(self, width: int, heads: int, mlp_dim: int, eps: float):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.qkv = nn.Linear(width, 3 * width)
        self.projection = nn.Linear(width, width)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # HF's reshape(B, L, 3, H, hd): q, k and v are the fused output's thirds
        q, k, v = self.qkv(self.layer_norm1(x)).chunk(3, dim=-1)
        x = x + self.projection(attend(q, k, v, self.heads))
        return x + self.fc2(F.gelu(self.fc1(self.layer_norm2(x))))


class BlipVisionTower(nn.Module):
    """(B, H, W, 3) normalised NHWC pixels -> (B, 1 + G^2, width) token
    states after ``post_layernorm``."""

    def __init__(self, width: int, layers: int, heads: int, mlp_dim: int, image_size: int, patch_size: int,
                 eps: float):
        super().__init__()
        n = (image_size // patch_size) ** 2 + 1
        self.patch_embedding = nn.Conv2d(3, width, patch_size, patch_size)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.position_embedding = nn.Parameter(torch.empty(n, width))
        self.blocks = nn.ModuleList(BlipVisionBlock(width, heads, mlp_dim, eps) for _ in range(layers))
        self.post_layernorm = nn.LayerNorm(width, eps=eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(x.shape[0], 1, -1), x], dim=1) + self.position_embedding
        for block in self.blocks:
            x = block(x)
        return self.post_layernorm(x)


class BlipItmModel(nn.Module):
    def __init__(self, cfg: BlipItmConfig):
        super().__init__()
        self.cfg = cfg
        v = cfg.vision
        self.vision = BlipVisionTower(v.hidden_size, v.num_layers, v.num_heads, v.intermediate_size, v.image_size,
                                      v.patch_size, v.layer_norm_eps)
        self.text = BlipTextEncoder(cfg.text)
        self.itm_head = nn.Linear(cfg.text.hidden_size, 2)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """ITM logits (B, 2): [no match, match]."""
        states = self.text(input_ids, attention_mask, self.vision(pixels))
        return self.itm_head(states[:, 0])


@torch.no_grad()
def init_blip_itm(model: nn.Module, seed: int = 0) -> nn.Module:
    """A seeded random init on the model's device: linear and conv weights,
    embeddings and tokens N(0, 0.02) (HF's ``initializer_range``), biases 0,
    LayerNorms at identity."""
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            continue
        for name, p in module.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


# (HF name, port name) prefixes; {i} stands for a layer index. HF names
# that match none (the unused contrastive heads) are left out.
VISION_NAMES = (
    ("vision_model.embeddings.patch_embedding.", "{v}.patch_embedding."),
    ("vision_model.embeddings.class_embedding", "{v}.class_embedding"),
    ("vision_model.embeddings.position_embedding", "{v}.position_embedding"),
    ("vision_model.encoder.layers.{i}.self_attn.qkv.", "{v}.blocks.{i}.qkv."),
    ("vision_model.encoder.layers.{i}.self_attn.projection.", "{v}.blocks.{i}.projection."),
    ("vision_model.encoder.layers.{i}.mlp.fc1.", "{v}.blocks.{i}.fc1."),
    ("vision_model.encoder.layers.{i}.mlp.fc2.", "{v}.blocks.{i}.fc2."),
    ("vision_model.encoder.layers.{i}.layer_norm1.", "{v}.blocks.{i}.layer_norm1."),
    ("vision_model.encoder.layers.{i}.layer_norm2.", "{v}.blocks.{i}.layer_norm2."),
    ("vision_model.post_layernorm.", "{v}.post_layernorm."),
)
_T = "text_encoder.encoder.layer.{i}."
_ITM_NAMES = tuple((hf, port.replace("{v}", "vision")) for hf, port in VISION_NAMES) + (
    ("text_encoder.embeddings.word_embeddings.weight", "text.word_embeddings"),
    ("text_encoder.embeddings.position_embeddings.weight", "text.position_embeddings"),
    ("text_encoder.embeddings.LayerNorm.", "text.ln_emb."),
    (_T + "attention.self.query.", "text.layers.{i}.q."),
    (_T + "attention.self.key.", "text.layers.{i}.k."),
    (_T + "attention.self.value.", "text.layers.{i}.v."),
    (_T + "attention.output.dense.", "text.layers.{i}.attn_out."),
    (_T + "attention.output.LayerNorm.", "text.layers.{i}.ln_attn."),
    (_T + "crossattention.self.query.", "text.layers.{i}.cross_q."),
    (_T + "crossattention.self.key.", "text.layers.{i}.cross_k."),
    (_T + "crossattention.self.value.", "text.layers.{i}.cross_v."),
    (_T + "crossattention.output.dense.", "text.layers.{i}.cross_out."),
    (_T + "crossattention.output.LayerNorm.", "text.layers.{i}.ln_cross."),
    (_T + "intermediate.dense.", "text.layers.{i}.ffn_in."),
    (_T + "output.dense.", "text.layers.{i}.ffn_out."),
    (_T + "output.LayerNorm.", "text.layers.{i}.ln_ffn."),
    ("itm_head.", "itm_head."),
)


def rename(name: str, names, reverse: bool = False) -> Optional[str]:
    """``name`` under the first (source, target) prefix pair of ``names``
    whose source it starts with (``reverse``: target to source), the layer
    index carried over; None when no pair matches."""
    for src, dst in names:
        if reverse:
            src, dst = dst, src
        m = re.match(re.escape(src).replace(r"\{i\}", r"(\d+)"), name)
        if m:
            return (dst.replace("{i}", m.group(1)) if m.groups() else dst) + name[m.end():]
    return None


def unbatch(name: str, t: torch.Tensor) -> torch.Tensor:
    """HF's class token (1, 1, D), positions and query tokens (1, N, D) ->
    the port's (D,) and (N, D)."""
    if name.endswith("class_embedding"):
        return t.reshape(t.shape[-1])
    if name.endswith(("position_embedding", "query_tokens")) and t.dim() == 3:
        return t[0]
    return t


def from_hf_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``BlipForImageTextRetrieval`` state dict -> :class:`BlipItmModel`'s
    (the contrastive ``vision_proj``/``text_proj`` heads, which ITM does not
    use, are left out)."""
    out = {}
    for name, t in sd.items():
        new = rename(name, _ITM_NAMES)
        if new is not None:
            out[new] = unbatch(new, t)
    return out


def to_hf_state_dict(model: BlipItmModel) -> Dict[str, torch.Tensor]:
    out = {}
    for name, t in model.state_dict().items():
        hf = rename(name, _ITM_NAMES, reverse=True)
        if hf is None:
            raise KeyError(f"no HF name for {name}")
        out[hf] = t[None, None] if name.endswith("class_embedding") else (
            t[None] if name.endswith("position_embedding") else t)
    return out


def _check(kind: str, got: Optional[str], want: str) -> None:
    if got is not None and got != want:
        raise ValueError(f"{kind} {got!r} is not modelled (want {want!r})")


def blip_itm_config_from_hf(cfg: Mapping) -> BlipItmConfig:
    """A parsed ``config.json`` of a BLIP ITM checkpoint, HF's defaults
    filling every omitted key. ``BlipConfig`` sets the text encoder's
    ``encoder_hidden_size`` to the vision width, as here."""
    _check("model_type", cfg.get("model_type"), "blip")
    t, v = dict(cfg.get("text_config") or {}), dict(cfg.get("vision_config") or {})
    _check("text_config.model_type", t.get("model_type"), "blip_text_model")
    _check("vision_config.model_type", v.get("model_type"), "blip_vision_model")
    for part, sub in (("text", t), ("vision", v)):
        _check(f"{part} hidden_act", sub.get("hidden_act", "gelu"), "gelu")
    if t.get("position_embedding_type", "absolute") != "absolute":
        raise ValueError(f"position_embedding_type {t['position_embedding_type']!r} is not modelled")
    vd = BlipVisionConfig()
    vision = BlipVisionConfig(
        hidden_size=v.get("hidden_size", vd.hidden_size),
        intermediate_size=v.get("intermediate_size", vd.intermediate_size),
        num_layers=v.get("num_hidden_layers", vd.num_layers), num_heads=v.get("num_attention_heads", vd.num_heads),
        image_size=v.get("image_size", vd.image_size), patch_size=v.get("patch_size", vd.patch_size),
        layer_norm_eps=v.get("layer_norm_eps", vd.layer_norm_eps),
    )
    td = blip_text_config()
    text = blip_text_config(
        vocab_size=t.get("vocab_size", td.vocab_size), hidden_size=t.get("hidden_size", td.hidden_size),
        num_layers=t.get("num_hidden_layers", td.num_layers), num_heads=t.get("num_attention_heads", td.num_heads),
        intermediate_size=t.get("intermediate_size", td.intermediate_size),
        max_position_embeddings=t.get("max_position_embeddings", td.max_position_embeddings),
        layer_norm_eps=t.get("layer_norm_eps", td.layer_norm_eps), encoder_hidden_size=vision.hidden_size,
    )
    return BlipItmConfig(vision=vision, text=text)


def _hf_config(cfg: BlipItmConfig) -> dict:
    v, t = cfg.vision, cfg.text
    return {
        "architectures": ["BlipForImageTextRetrieval"], "model_type": "blip",
        "text_config": {"model_type": "blip_text_model", "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
                        "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
                        "intermediate_size": t.intermediate_size,
                        "max_position_embeddings": t.max_position_embeddings, "layer_norm_eps": t.layer_norm_eps,
                        "encoder_hidden_size": t.encoder_hidden_size, "hidden_act": "gelu"},
        "vision_config": {"model_type": "blip_vision_model", "hidden_size": v.hidden_size,
                          "intermediate_size": v.intermediate_size, "num_hidden_layers": v.num_layers,
                          "num_attention_heads": v.num_heads, "image_size": v.image_size,
                          "patch_size": v.patch_size, "layer_norm_eps": v.layer_norm_eps, "hidden_act": "gelu"},
    }


class BlipImageProcessor:
    """``BlipImageProcessor``'s arithmetic on a list of uint8 HWC images ->
    (B, H, W, 3) float32 NHWC: PIL resize (``resample``, 3 = bicubic) of
    the uint8 image to (height, width), ``x * rescale_factor`` in float64
    cast to float32, then ``(x - mean) / std`` in float32."""

    def __init__(self, height: int = 384, width: int = 384, mean=CLIP_MEAN, std=CLIP_STD,
                 rescale_factor: float = RESCALE, resample: int = 3):
        self.size = (height, width)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.rescale_factor = rescale_factor
        self.resample = resample

    @staticmethod
    def from_dir(path: Path, default_size: int = 384) -> "BlipImageProcessor":
        f = Path(path) / "preprocessor_config.json"
        c = json.loads(f.read_text()) if f.exists() else {}
        size = c.get("size") or {"height": default_size, "width": default_size}
        if "height" not in size:
            raise ValueError(f"{f}: BlipImageProcessor takes size {{height, width}}, got {size}")
        return BlipImageProcessor(size["height"], size["width"], c.get("image_mean", CLIP_MEAN),
                                  c.get("image_std", CLIP_STD), c.get("rescale_factor", RESCALE),
                                  c.get("resample", 3))

    def __call__(self, images_u8: Sequence[np.ndarray]) -> np.ndarray:
        from PIL import Image

        h, w = self.size
        out = []
        for img in images_u8:
            im = Image.fromarray(np.asarray(img, np.uint8)).convert("RGB")
            x = np.asarray(im.resize((w, h), resample=self.resample, reducing_gap=None))
            x = (x.astype(np.float64) * self.rescale_factor).astype(np.float32)
            out.append((x - self.mean) / self.std)
        return np.stack(out)


class BlipItm:
    """A loaded ITM scorer: the model on its device, the image processor and
    the tokenizer."""

    def __init__(self, model: BlipItmModel, processor: BlipImageProcessor, tokenizer: WordPieceTokenizer,
                 max_length: int, device: torch.device):
        self.model = model.to(device).eval()
        self.processor = processor
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.device = device

    def inputs(self, images_u8, captions) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(pixels, input_ids, attention_mask) on the model's device."""
        ids, mask = self.tokenizer.batch(list(captions), self.max_length)
        pixels = torch.from_numpy(self.processor(images_u8))
        return pixels.to(self.device), torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)

    @torch.no_grad()
    def logits(self, images_u8, captions) -> torch.Tensor:
        return self.model(*self.inputs(images_u8, captions))

    def p_match(self, images_u8, captions) -> np.ndarray:
        return torch.softmax(self.logits(images_u8, captions), dim=1)[:, 1].float().cpu().numpy()


def load_blip_itm(checkpoint_dir, device: torch.device) -> BlipItm:
    """A local ``save_pretrained`` directory of ``BlipForImageTextRetrieval``
    -> :class:`BlipItm` on ``device``."""
    d = Path(checkpoint_dir)
    cfg = blip_itm_config_from_hf(json.loads((d / "config.json").read_text()))
    if (d / "model.safetensors").exists():
        sd = load_file(d / "model.safetensors")
    elif (d / "pytorch_model.bin").exists():
        sd = torch.load(d / "pytorch_model.bin", map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{d}: no model.safetensors or pytorch_model.bin")
    model = BlipItmModel(cfg)
    model.load_state_dict(from_hf_state_dict(sd))
    tok_cfg_path = d / "tokenizer_config.json"
    tok_cfg = json.loads(tok_cfg_path.read_text()) if tok_cfg_path.exists() else {}
    tokenizer = WordPieceTokenizer(d / "vocab.txt", lowercase=tok_cfg.get("do_lower_case", True))
    max_length = min(int(tok_cfg.get("model_max_length", cfg.text.max_position_embeddings)),
                     cfg.text.max_position_embeddings)
    return BlipItm(model, BlipImageProcessor.from_dir(d, cfg.vision.image_size), tokenizer, max_length, device)


def save_blip_itm(model: BlipItmModel, out_dir, vocab: Sequence[str], model_max_length: int = 512) -> Path:
    """Write ``model`` as a ``save_pretrained``-layout directory that
    :func:`load_blip_itm` (and HF's loader) reads: ``config.json``,
    ``model.safetensors`` (the port's writer), ``vocab.txt``,
    ``tokenizer_config.json``, ``preprocessor_config.json``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = model.cfg
    (out / "config.json").write_text(json.dumps(_hf_config(cfg), indent=2))
    save_file(to_hf_state_dict(model), out / "model.safetensors", metadata={"format": "pt"})
    (out / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (out / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True, "model_max_length": model_max_length}))
    s = cfg.vision.image_size
    (out / "preprocessor_config.json").write_text(json.dumps(
        {"image_processor_type": "BlipImageProcessor", "size": {"height": s, "width": s},
         "image_mean": [float(x) for x in CLIP_MEAN], "image_std": [float(x) for x in CLIP_STD],
         "rescale_factor": RESCALE, "resample": 3}))
    return out


def blip_itm_scorer(checkpoint_dir, device: torch.device, batch_size: int = 16) -> Callable:
    """``score(images_u8, captions) -> P(match)`` (float32 numpy) from a
    local checkpoint directory, in batches of ``batch_size`` on ``device``:
    the port of ``hf_blip_itm_scorer`` (lemon_tpu/baselines/capfilt.py:29-49)."""
    itm = load_blip_itm(checkpoint_dir, device)

    def score(images_u8, captions):
        out = []
        for start in range(0, len(captions), batch_size):
            stop = min(start + batch_size, len(captions))
            out.append(itm.p_match([images_u8[i] for i in range(start, stop)], list(captions[start:stop])))
        return np.concatenate(out)

    return score
