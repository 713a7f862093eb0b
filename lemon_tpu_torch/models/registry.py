"""Model factory (port of lemon_tpu/models/registry.py).

- ``'huggingface_clip'``              ViT-B/32; weights from an HF
  ``CLIPModel`` checkpoint or a JAX ``.npz`` tree when one is found
- ``'chexzero'``                      ViT-B/32, an OpenAI-format state dict
- ``'mimic_clip_from_scratch_random'``,
  ``'mimic_clip_from_scratch_cat'``   ViT-B/16 at 224 px, embed 768,
  text context 256
- ``'cc3m_clip_from_scratch'``        ViT-B/16, embed 768, context 77
- ``'laion_vit_h14'``                 LAION's OpenCLIP ViT-H/14 (16 heads of
  80, exact GELU); the port's alone, the JAX registry has no such entry
- ``'rn50'``                          OpenAI CLIP RN50 (ModifiedResNet tower)
- ``'biomed_clip'``                   BiomedCLIP: timm ViT-B/16 + PubMedBERT
  (:mod:`lemon_tpu_torch.models.biomed`), in fp32 whatever the mode
- ``'tiny'``                          test-scale config

Checkpoint resolution (lemon_tpu/models/registry.py:41-51): the
``LEMON_TPU_CKPT_<NAME>`` environment variable, then
``<data_root>/checkpoints/<name>.{npz,pt,bin,safetensors}``; a checkpoint
in either format (HF or OpenAI) loads under any name, with the entry's
heads and GELU when its shapes are the entry's (shapes cannot tell them),
else with the config its shapes give. Without one the
weights are a seeded random init, announced loudly: fine for benchmarks and
synthetic data, wrong for real-data results. The precision mode comes from
``LEMON_TPU_PRECISION`` unless the caller passes one
(lemon_tpu/models/registry.py:96-116); ``biomed_clip`` ignores it, as the
JAX registry does, and runs in fp32. Its tokens are WordPiece ids over the
``vocab.txt`` that ``LEMON_TPU_BIOMED_VOCAB`` names; without one, CLIP BPE
ids clipped to the BERT vocabulary stand in, with the JAX package's warning
(:153-165).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from lemon_tpu_torch.core.mesh import Mesh
from lemon_tpu_torch.core.precision import Precision, default_precision
from lemon_tpu_torch.data.datasets import data_root
from lemon_tpu_torch.models.biomed import BiomedClipConfig, BiomedClipModel, from_open_clip_state_dict, init_biomed
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel, init_weights
from lemon_tpu_torch.models.convert import from_flax_params, load_flax_npz
from lemon_tpu_torch.models.encoder import ClipEncoder
from lemon_tpu_torch.models.loader import detect_and_convert, load_torch_file, with_entry_heads
from lemon_tpu_torch.models.safetensors_io import load_numpy
from lemon_tpu_torch.models.tokenizer import tokenize_batch
from lemon_tpu_torch.models.wordpiece import WordPieceTokenizer

MODEL_CONFIGS = {
    "huggingface_clip": ClipConfig.vit_b32(),
    "chexzero": ClipConfig.vit_b32(),
    "mimic_clip_from_scratch_random": ClipConfig.from_scratch_mimic(),
    "mimic_clip_from_scratch_cat": ClipConfig.from_scratch_mimic(),
    "cc3m_clip_from_scratch": ClipConfig.vit_b16(embed_dim=768, context_length=77),
    "laion_vit_h14": ClipConfig.vit_h14(),  # open_clip ViT-H-14, laion2b_s32b_b79k
    "rn50": ClipConfig.rn50(),  # ModifiedResNet tower (chexzero_clip.py:120-174)
    "tiny": ClipConfig.tiny(),
}


def checkpoint_path(name: str) -> Optional[Path]:
    env = os.environ.get(f"LEMON_TPU_CKPT_{name.upper()}")
    if env:
        return Path(env)
    for suffix in (".npz", ".pt", ".bin", ".safetensors"):
        cand = data_root() / "checkpoints" / f"{name}{suffix}"
        if cand.exists():
            return cand
    return None


def checkpoint_fingerprint(ckpt: Optional[Path], seed: int, cfg: Union[ClipConfig, BiomedClipConfig]) -> str:
    """Weights identity for cache keys: the seed and the model's config for a
    random init (one seed gives every model other weights), else the
    resolved path + mtime + size."""
    if ckpt is None:
        return f"random:{seed}:{cfg!r}"
    st = ckpt.stat()
    return f"{ckpt.resolve()}:{st.st_mtime_ns}:{st.st_size}"


def load_checkpoint(path: Path, cfg: ClipConfig):
    """(state dict, config) from a JAX ``.npz`` tree, or an HF or
    OpenAI-format checkpoint (:func:`with_entry_heads`: the entry ``cfg``'s
    heads and GELU where the shapes are its own)."""
    if path.suffix == ".npz":
        return from_flax_params(load_flax_npz(path)), cfg
    if path.suffix == ".safetensors":
        sd = load_numpy(path)  # the port's own reader: the GPU machine has no safetensors package
    else:
        sd = load_torch_file(path)
    tree, shaped = detect_and_convert({k: v for k, v in sd.items() if "position_ids" not in k})
    return from_flax_params(tree), with_entry_heads(shaped, cfg)


def create_encoder(name: str, device: torch.device, seed: int = 0, batch_size: int = 128, checkpoint: Optional[str] = None,
                   precision: Optional[Precision] = None, mesh: Optional[Mesh] = None) -> ClipEncoder:
    """A frozen encoder for a registry name (run_lemon.py:112-115), in
    ``precision`` (``None``: :func:`default_precision`, the environment's),
    sharding its batches over ``mesh`` when one is given."""
    if name == "biomed_clip":
        return _create_biomed_encoder(device, seed, batch_size, checkpoint, mesh)
    precision = precision or default_precision()
    if name not in MODEL_CONFIGS:
        raise KeyError(f"unknown clip_model '{name}'; options: {sorted(MODEL_CONFIGS) + ['biomed_clip']}")
    cfg = MODEL_CONFIGS[name]
    ckpt = Path(checkpoint) if checkpoint else checkpoint_path(name)
    if ckpt is not None:
        state, cfg = load_checkpoint(ckpt, cfg)
        model = ClipModel(cfg, precision)
        model.load_state_dict(state)
        print(f"[lemon_tpu_torch] loaded {name} weights from {ckpt}")
    else:
        model = init_weights(ClipModel(cfg, precision), seed=seed)
        print(
            f"[lemon_tpu_torch] WARNING: no checkpoint for '{name}' "
            f"(set LEMON_TPU_CKPT_{name.upper()}); using random init (seed {seed})"
        )
    print(f"[lemon_tpu_torch] precision: {precision}")
    return ClipEncoder(model, device, batch_size=batch_size, weights_fingerprint=checkpoint_fingerprint(ckpt, seed, cfg),
                       mesh=mesh)


def _create_biomed_encoder(device: torch.device, seed: int, batch_size: int, checkpoint: Optional[str],
                           mesh: Optional[Mesh]) -> ClipEncoder:
    """BiomedCLIP (lemon_tpu/models/registry.py:127-169): weights from an
    open_clip checkpoint (``LEMON_TPU_CKPT_BIOMED_CLIP`` or ``checkpoint``)
    or a seeded random init; fp32."""
    cfg = BiomedClipConfig()
    ckpt = Path(checkpoint) if checkpoint else checkpoint_path("biomed_clip")
    if ckpt is not None:
        tree, cfg = from_open_clip_state_dict(load_torch_file(ckpt), cfg)
        model = BiomedClipModel(cfg)
        model.load_state_dict(from_flax_params(tree))
        print(f"[lemon_tpu_torch] loaded biomed_clip weights from {ckpt}")
    else:
        model = init_biomed(BiomedClipModel(cfg), seed=seed)
        print(f"[lemon_tpu_torch] WARNING: no checkpoint for 'biomed_clip' (set LEMON_TPU_CKPT_BIOMED_CLIP); "
              f"using random init (seed {seed})")
    vocab = os.environ.get("LEMON_TPU_BIOMED_VOCAB")
    if vocab and Path(vocab).exists():
        wordpiece = WordPieceTokenizer(vocab)

        def tokenize_fn(texts):
            return wordpiece(texts, cfg.context_length)
    else:
        def tokenize_fn(texts):
            return (np.asarray(tokenize_batch(list(texts), cfg.context_length)) % cfg.text.vocab_size).astype(np.int32)

        print("[lemon_tpu_torch] WARNING: no PubMedBERT vocab (LEMON_TPU_BIOMED_VOCAB); using clipped CLIP-BPE ids")
    print(f"[lemon_tpu_torch] precision: {model.precision} (biomed_clip runs in fp32 in every mode)")
    return ClipEncoder(model, device, batch_size=batch_size, weights_fingerprint=checkpoint_fingerprint(ckpt, seed, cfg),
                       tokenize_fn=tokenize_fn, mesh=mesh)
