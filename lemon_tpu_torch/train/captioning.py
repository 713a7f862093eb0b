"""Downstream filter-then-train captioning (port of
lemon_tpu/train/captioning.py; reference downstream_captioning.py).

Filter the training captions by a detector's scores (percentile threshold,
:229-240), fine-tune a captioner (optionally its LoRA adapters only,
:216-224) with optax's AdamW on a warmup-cosine schedule (:273-277), keep
the best validation loss with early stopping (:268-270, :381-394), generate
captions for the test split (:424-440), and score the test split by each
pair's LM loss (the loss-based detection mode, :51-79).

- The optimizer is ``train/contrastive.Optimizer`` over the trainable
  parameters only: optax's ``multi_transform`` with ``set_to_zero`` leaves
  the masked parameters unchanged (no update, no weight decay), and so does
  leaving them out. Under ``lora_only`` the LoRA factors and ``lm_head``
  train (``captioner.lora_trainable_mask``); under a config's
  ``freeze_vision`` everything outside the vision tower
  (``captioner.frozen_vision_mask``).
- Batches have one shape: an epoch's last batch wraps around and its padded
  rows are masked out of the loss.
- Tokens: the CLIP BPE (ids folded into a reduced vocabulary, as in JAX),
  or for BLIP-2 the checkpoint's own OPT tokenizer
  (:class:`lemon_tpu_torch.models.gpt2_bpe.GPT2BPETokenizer`), or, when the
  directory ships no tokenizer files, the crc32 word-hash stand-in.

Outputs: captions.pkl (generated, gold and noisy), flip_labels.pkl,
detection_scores.npy, results.json, done. No kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import time
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.core.io import EarlyStopping, json_default
from lemon_tpu_torch.data.datasets import CaptioningSplit, iter_batches, load_images
from lemon_tpu_torch.models.blip2 import Blip2Config, load_blip2
from lemon_tpu_torch.models.captioner import (CaptionerConfig, CaptioningModel, frozen_vision_mask, init_captioner,
                                              lora_trainable_mask)
from lemon_tpu_torch.models.gpt2_bpe import TOKENIZER_FILES, GPT2BPETokenizer
from lemon_tpu_torch.models.tokenizer import get_tokenizer, tokenize_batch
from lemon_tpu_torch.ops.image import preprocess_device
from lemon_tpu_torch.scoring.metrics import prob_metrics
from lemon_tpu_torch.train.contrastive import Optimizer, warmup_cosine_decay_schedule

CLIP_VOCAB = 49408


@dataclasses.dataclass
class CaptionTrainConfig:
    percentile: float = 60.0
    epochs: int = 10
    batch_size: int = 32
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    warmup_frac: float = 0.1
    es_patience: int = 3
    seed: int = 0
    lora_only: bool = False
    model_cfg: CaptionerConfig = dataclasses.field(default_factory=CaptionerConfig.tiny)
    # a local HF Blip2ForConditionalGeneration directory: fine-tune from its
    # weights (models/blip2.load_blip2) instead of a random init
    blip2_checkpoint: Optional[str] = None


def _hf_tokenizer(checkpoint_dir: Optional[str]) -> Optional[GPT2BPETokenizer]:
    """The checkpoint directory's OPT tokenizer, or None when it ships no
    tokenizer files (lemon_tpu/train/captioning.py:89-98)."""
    if not checkpoint_dir or not any((Path(checkpoint_dir) / f).exists() for f in TOKENIZER_FILES):
        return None
    return GPT2BPETokenizer.from_dir(checkpoint_dir)


def _tokenize_captions(texts, cfg: CaptionerConfig, blip2_checkpoint: Optional[str] = None) -> np.ndarray:
    """(B, max_text_len) int64 caption tokens (:54-87)."""
    if isinstance(cfg, Blip2Config):
        tok = _hf_tokenizer(blip2_checkpoint)
        if tok is not None:
            return tok(list(texts), cfg.max_text_len)[0]
        toks = np.full((len(texts), cfg.max_text_len), cfg.pad_token_id, np.int64)
        toks[:, 0] = cfg.bos_token_id
        reserved = max(cfg.pad_token_id, cfg.bos_token_id, cfg.eos_token_id) + 1
        for r, text in enumerate(texts):
            for c, w in enumerate(str(text).split()[: cfg.max_text_len - 1]):
                # crc32: stable across processes, unlike the salted hash()
                toks[r, c + 1] = reserved + (zlib.crc32(w.encode()) % (cfg.vocab_size - reserved))
        return toks
    toks = np.asarray(tokenize_batch(list(texts), cfg.max_text_len))
    if cfg.vocab_size < CLIP_VOCAB:
        tok = get_tokenizer()
        toks = np.where(toks == tok.sot_id, cfg.vocab_size - 2,
                        np.where(toks == tok.eot_id, cfg.vocab_size - 1, toks % (cfg.vocab_size - 2)))
    return toks.astype(np.int64)


def filter_caption_split(split: CaptioningSplit, scores: np.ndarray, percentile: float) -> CaptioningSplit:
    """Keep the rows whose score is at most the percentile (:229-240)."""
    if len(scores) != len(split):
        raise ValueError(f"{len(scores)} scores for a split of {len(split)} rows")
    keep = np.flatnonzero(scores <= np.percentile(scores, percentile))
    if not len(keep):
        raise ValueError("the filter kept nothing (downstream_captioning.py:237-240)")
    return split.subset(keep)


def _pixels(split, idx, cfg: CaptionerConfig, device) -> torch.Tensor:
    size = cfg.vision.image_resolution
    return preprocess_device(load_images(split, idx, decode_size=size), size=size, device=device)


@torch.no_grad()
def per_sample_caption_losses(model: CaptioningModel, split: CaptioningSplit, cfg: CaptionTrainConfig,
                              device: torch.device) -> np.ndarray:
    """Loss-based detection scores: the LM loss of each (image, caption) pair."""
    mc = cfg.model_cfg
    model.eval()
    out = np.zeros(len(split), np.float64)
    for idx, n_valid in iter_batches(split, cfg.batch_size):
        tokens = torch.from_numpy(_tokenize_captions(split.sentence[idx], mc, cfg.blip2_checkpoint)).to(device)
        out[idx[:n_valid]] = model.per_sample_loss(_pixels(split, idx, mc, device), tokens)[:n_valid].cpu().numpy()
    return out


def trainable_names(model: CaptioningModel, cfg: CaptionTrainConfig) -> List[str]:
    """The parameters the optimizer updates (the JAX masks, :140-156)."""
    if cfg.lora_only:
        keep = lora_trainable_mask
    elif getattr(cfg.model_cfg, "freeze_vision", False):
        keep = frozen_vision_mask
    else:
        return [name for name, _ in model.named_parameters()]
    return [name for name, _ in model.named_parameters() if keep(name)]


def make_caption_step(model: CaptioningModel, tx: Optimizer, opt_state: Dict, params: List[torch.nn.Parameter]
                      ) -> Callable:
    """``step(pixels, tokens, mask) -> loss``: the masked mean of the
    per-sample losses and one update of ``params`` in place."""

    def step(pixels: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for p in params:
            p.grad = None
        per = model.train().per_sample_loss(pixels, tokens)
        m = mask.to(per.dtype)
        loss = (per * m).sum() / m.sum().clamp_min(1.0)
        loss.backward()
        tx.update(params, [p.grad if p.grad is not None else torch.zeros_like(p) for p in params], opt_state)
        return loss.detach()

    return step


def _token_ids(mc: CaptionerConfig, checkpoint: Optional[str]):
    """(bos, eot, pad, decode) for generation (:222-236)."""
    if isinstance(mc, Blip2Config):
        hf_tok = _hf_tokenizer(checkpoint)
        decode = (lambda ids: hf_tok.decode(ids).strip()) if hf_tok is not None else (
            lambda ids: " ".join(map(str, ids)))
        return mc.bos_token_id, mc.eos_token_id, mc.pad_token_id, decode
    tok = get_tokenizer()
    small = mc.vocab_size < CLIP_VOCAB
    bos = mc.vocab_size - 2 if small else tok.sot_id
    eot = mc.vocab_size - 1 if small else tok.eot_id
    decode = (lambda ids: " ".join(map(str, ids))) if small else (lambda ids: tok.decode(ids).strip())
    return bos, eot, 0, decode


def train_captioner(cfg: CaptionTrainConfig, splits: Dict[str, CaptioningSplit],
                    detector_scores: Optional[np.ndarray] = None, out_dir: Optional[Path] = None,
                    device: Optional[torch.device] = None) -> Dict:
    """Filter, fine-tune, generate and score on ``device`` (default: the
    CUDA card, raising without one). Returns the results, plus the generated
    captions and the best model (in memory only)."""
    device = resolve_device("cuda") if device is None else device
    mc = cfg.model_cfg
    train = splits["train"]
    if detector_scores is not None:
        train = filter_caption_split(train, detector_scores, cfg.percentile)
        print(f"filter: kept {len(train)}/{len(splits['train'])} captions")

    if cfg.blip2_checkpoint is not None:
        if not isinstance(mc, Blip2Config):
            raise ValueError("--blip2_checkpoint requires a Blip2Config model_cfg")
        model, loaded_cfg = load_blip2(cfg.blip2_checkpoint, lora_rank=mc.lora_rank, max_text_len=mc.max_text_len,
                                       seed=cfg.seed, device=device)
        if loaded_cfg != mc:
            raise ValueError("model_cfg disagrees with the checkpoint's architecture")
    else:
        model = init_captioner(mc, cfg.seed, device)
    names = set(trainable_names(model, cfg))
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(name in names)
        if name in names:
            params.append(p)
    steps_per_epoch = max(len(train) // cfg.batch_size, 1)
    schedule = warmup_cosine_decay_schedule(0.0, cfg.learning_rate,
                                            max(int(cfg.warmup_frac * cfg.epochs * steps_per_epoch), 1),
                                            cfg.epochs * steps_per_epoch)
    tx = Optimizer("adamw", schedule, weight_decay=cfg.weight_decay)
    step = make_caption_step(model, tx, tx.init(params), params)

    rng = np.random.default_rng(cfg.seed)
    es = EarlyStopping(patience=cfg.es_patience, mode="min")
    es.seed(np.inf, model)  # any real val loss beats the placeholder
    t0 = time.time()
    losses: List[float] = []  # empty for epochs=0 (score and generate from the init)
    for epoch in range(cfg.epochs):
        order = rng.permutation(len(train))
        losses = []
        for start in range(0, len(order), cfg.batch_size):
            idx = order[start : start + cfg.batch_size]
            n_valid = len(idx)
            if n_valid < cfg.batch_size:
                idx = np.concatenate([idx, np.resize(order, cfg.batch_size - n_valid)])
            tokens = torch.from_numpy(_tokenize_captions(train.sentence[idx], mc, cfg.blip2_checkpoint)).to(device)
            mask = torch.arange(cfg.batch_size, device=device) < n_valid
            losses.append(float(step(_pixels(train, idx, mc, device), tokens, mask)))
        vl = float(per_sample_caption_losses(model, splits["val"], cfg, device).mean())
        print(f"epoch {epoch}: train_loss {np.mean(losses):.4f} val_loss {vl:.4f}")
        es.step(vl, model)
        if es.should_stop:
            print(f"early stop at epoch {epoch}")
            break
    model.load_state_dict(es.best_payload)
    runtime = time.time() - t0

    bos, eot, pad, decode = _token_ids(mc, cfg.blip2_checkpoint)
    generated = []
    test = splits["test"]
    model.eval()
    for idx, n_valid in iter_batches(test, cfg.batch_size):
        toks = model.generate(_pixels(test, idx, mc, device), bos, eot)[:n_valid].cpu().numpy()
        for row in toks:
            generated.append(decode([int(t) for t in row[1:] if t not in (0, pad, bos, eot)]))

    results = {"val_loss_best": es.best, "runtime_s": runtime, "n_train": len(train),
               "train_loss_final": float(np.mean(losses)) if losses else None}
    det_scores = per_sample_caption_losses(model, test, cfg, device)
    flips = np.asarray(test.is_mislabel).astype(int)
    if 0 < flips.sum() < len(flips):
        results["test_loss_detection_AUROC"] = float(prob_metrics(flips, det_scores)["AUROC"])
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "captions.pkl", "wb") as f:
            pickle.dump({"generated": generated, "gold": list(test.gold_sentence), "noisy": list(test.sentence)}, f)
        with open(out_dir / "flip_labels.pkl", "wb") as f:
            pickle.dump(test.is_mislabel, f)
        np.save(out_dir / "detection_scores.npy", det_scores)
        (out_dir / "results.json").write_text(json.dumps(results, default=json_default))
        (out_dir / "done").write_text("done")
    results["generated"] = generated
    results["model"] = model  # in memory only (results.json above leaves it out)
    return results
