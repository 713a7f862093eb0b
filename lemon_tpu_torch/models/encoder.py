"""Batched CLIP embedding engine (port of lemon_tpu/models/encoder.py:31-328).

Texts are tokenised on the host; each batch then runs device preprocessing,
both towers and L2 normalisation on the device. Batches keep one shape (the
tail batch is padded by repeating its last row, and the padding rows are
dropped afterwards), the embeddings stay on the device until one
concatenation and one copy per modality at the end of a split, and batch
assembly (image gather + BPE) runs one batch ahead on a background thread.
``embed_split`` can cache a split's embeddings as an ``.npz`` keyed on their
content (``cache_key``).
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from lemon_tpu_torch.data.datasets import Prefetcher, Split, iter_batches, load_images
from lemon_tpu_torch.models.clip import ClipModel
from lemon_tpu_torch.models.tokenizer import get_tokenizer, tokenize_batch
from lemon_tpu_torch.ops.image import preprocess_device


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class ClipEncoder:
    """Frozen CLIP wrapper: numpy in, L2-normalised numpy embeddings out."""

    def __init__(self, model: ClipModel, device: torch.device, batch_size: int = 128, weights_fingerprint: str = "unknown"):
        self.model = model.to(device).eval()
        self.cfg = model.cfg
        self.device = device
        self.batch_size = batch_size
        # identity of the weights (checkpoint path+mtime+size, or "random:<seed>")
        self.weights_fingerprint = weights_fingerprint
        self.tokenizer = get_tokenizer()

    def _tokenize(self, texts: Sequence[str]) -> np.ndarray:
        return tokenize_batch(list(texts), self.cfg.context_length, self.tokenizer)

    @torch.inference_mode()
    def _embed_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(tokens).to(self.device, non_blocking=True).long()
        return _l2_normalize(self.model.encode_text(t))

    @torch.inference_mode()
    def _embed_images(self, images_u8: np.ndarray) -> torch.Tensor:
        pixels = preprocess_device(images_u8, size=self.cfg.image_resolution, device=self.device)
        return _l2_normalize(self.model.encode_image(pixels))

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        bs = self.batch_size
        for start in range(0, len(texts), bs):
            chunk = list(texts[start : start + bs])
            n_valid = len(chunk)
            if n_valid < bs and len(texts) > bs:
                chunk = chunk + [chunk[-1]] * (bs - n_valid)
            out.append(self._embed_tokens(self._tokenize(chunk))[:n_valid])
        if not out:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        return torch.cat(out).cpu().numpy()

    def encode_images(self, images_u8: np.ndarray) -> np.ndarray:
        out = []
        bs = self.batch_size
        n = len(images_u8)
        for start in range(0, n, bs):
            batch = images_u8[start : start + bs]
            n_valid = len(batch)
            if n_valid < bs and n > bs:
                batch = np.concatenate([batch, np.repeat(batch[-1:], bs - n_valid, 0)])
            out.append(self._embed_images(batch)[:n_valid])
        if not out:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        return torch.cat(out).cpu().numpy()

    def cache_key(self, split: Split, texts: Sequence[str]) -> str:
        """Content-addressed identity of what :meth:`embed_split` returns:
        the rendered (noisy) texts, the image source, the weights and the
        numerics (lemon_tpu/models/encoder.py:196-242)."""
        h = hashlib.md5()
        for t in texts:
            h.update(str(t).encode())
            h.update(b"\x00")
        if split.paths is not None:
            for p in split.paths:
                h.update(str(p).encode())
                h.update(b"\x01")
        else:
            h.update(str(split.images.shape).encode())
            h.update(np.ascontiguousarray(split.images).tobytes())
        h.update(self.weights_fingerprint.encode())
        h.update(b"lemon_tpu_torch:fp32")
        return h.hexdigest()

    def embed_split(
        self,
        split: Split,
        texts: Sequence[str],
        cache_key: Optional[str] = None,
        cache_dir: Optional[Path] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(image embeddings, text embeddings) of a split and its rendered
        texts; optionally cached on disk."""
        path = None
        if cache_key is not None and cache_dir is not None:
            cache_dir = Path(cache_dir)
            path = cache_dir / f"emb_{hashlib.md5(cache_key.encode()).hexdigest()}.npz"
            if path.exists():
                try:
                    with np.load(path) as blob:
                        return blob["img"], blob["txt"]
                except (OSError, KeyError, ValueError) as e:  # torn or foreign file
                    print(f"embedding cache: unreadable {path} ({e}); re-embedding", flush=True)

        def assemble(item):
            idx, n_valid = item
            images = load_images(split, idx, decode_size=self.cfg.image_resolution)
            return images, self._tokenize([texts[i] for i in idx]), n_valid

        img_chunks, txt_chunks = [], []
        prefetcher = Prefetcher(iter_batches(split, self.batch_size), assemble, depth=2)
        try:
            for images, tokens, n_valid in prefetcher:
                img_chunks.append(self._embed_images(images)[:n_valid])
                txt_chunks.append(self._embed_tokens(tokens)[:n_valid])
        finally:
            prefetcher.close()  # unblock and join the worker if the loop raised
        img = torch.cat(img_chunks).cpu().numpy()
        txt = torch.cat(txt_chunks).cpu().numpy()

        if path is not None:
            cache_dir.mkdir(parents=True, exist_ok=True)
            # atomic publish: concurrent writers of one key write equal bytes
            tmp = cache_dir / f"{path.stem}.{os.getpid()}.tmp.npz"
            np.savez(tmp, img=img, txt=txt)
            os.replace(tmp, path)
        return img, txt
