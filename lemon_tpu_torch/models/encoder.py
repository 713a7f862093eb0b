"""Batched CLIP embedding engine (port of lemon_tpu/models/encoder.py:31-328).

Texts are tokenised on the host; each batch then runs device preprocessing,
both towers and L2 normalisation on the device. A ``ClipModel``'s text tower
is causal and pools each row at its first EOT (the largest id), so each text
batch is cut on the host to its longest pooled position before the upload;
no position after it reaches an embedding. Batches keep one number of rows
(the tail batch is padded by repeating its last row, and the padding rows
are dropped afterwards), the embeddings stay on the device until one
concatenation and one copy per modality at the end of a split, and batch
assembly (image gather + BPE) runs one batch ahead on a background thread.
``embed_split`` can cache a split's embeddings as an ``.npz`` keyed on their
content and the model's precision (``cache_key``, which reads no pixel of a
store that has a fingerprint and a 64-row sample of one that has none).
Any model with ``cfg``, ``precision``, ``encode_image`` and ``encode_text``
fits (``ClipModel``, ``BiomedClipModel``); ``tokenize_fn`` replaces the
CLIP BPE (WordPiece for BiomedCLIP).

Under a profiler session (:mod:`lemon_tpu_torch.core.profiling`) each tower
call is a span that counts its work from the host arrays, before the
upload: ``embed.images`` the rows the image tower ran (``image_rows``),
``embed.texts`` the text tower's (``text_rows``) and, for ``ClipModel``,
the positions it ran (``positions``, rows x the cut length) and those up to
and with each row's first EOT (``eot_positions``), where it pools. Rows read
from the ``.npz`` cache run no tower and count nothing.

The model's :class:`~lemon_tpu_torch.core.precision.Precision` sets the
rest, as in lemon_tpu/models/encoder.py:51-104: the int8 modes' weights are
quantised once, when the model's weights are loaded
(``ClipModel.load_state_dict``); ``int8_static`` calibrates its activation
scales on the first image batch the encoder embeds (``encode_images`` or
``embed_split``; the text tower is never quantised); a bf16 compute dtype
takes the fast resize (no uint8 rounding emulation, one bf16 pass).

With a ``mesh`` (:mod:`lemon_tpu_torch.core.mesh`) every rank builds the same
batches, padded as on one device, embeds its data rank's rows of each (a
text batch cut to those rows' longest pooled position, the same on every
rank of a model group) and all-gathers the embeddings over the data group
(lemon_tpu/models/encoder.py:125-135), so every rank holds every embedding;
the model axis replicates the work.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.core.mesh import Mesh, all_gather_rows, shard_batch
from lemon_tpu_torch.data.datasets import Prefetcher, Split, iter_batches, load_images
from lemon_tpu_torch.data.streaming import is_lazy_store
from lemon_tpu_torch.models.clip import ClipModel, calibrate_act_scales
from lemon_tpu_torch.models.tokenizer import get_tokenizer, tokenize_batch
from lemon_tpu_torch.ops.image import preprocess_device


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class ClipEncoder:
    """Frozen CLIP wrapper: numpy in, L2-normalised numpy embeddings out.
    ``ClipEncoder.npz_hits`` counts the splits read from the ``.npz`` cache."""

    npz_hits = 0

    def __init__(self, model: ClipModel, device: torch.device, batch_size: int = 128, weights_fingerprint: str = "unknown",
                 tokenize_fn: Optional[Callable[[Sequence[str]], np.ndarray]] = None, mesh: Optional[Mesh] = None):
        self.model = model.to(device).eval()
        self.cfg = model.cfg
        self.device = device
        self.batch_size = batch_size
        self.mesh = mesh
        # identity of the weights (checkpoint path+mtime+size, or "random:<seed>")
        self.weights_fingerprint = weights_fingerprint
        self.tokenizer = get_tokenizer()
        self._tokenize_fn = tokenize_fn
        precision = model.precision
        self._calibrated = not precision.int8_static_act
        fast_resize = precision.compute_dtype == torch.bfloat16
        self._pp_kwargs = {"pil_rounding": False, "precision": "default"} if fast_resize else {}

    def _tokenize(self, texts: Sequence[str]) -> np.ndarray:
        with profiling.span("embed.tokenize"):
            if self._tokenize_fn is not None:
                return self._tokenize_fn(list(texts))
            return tokenize_batch(list(texts), self.cfg.context_length, self.tokenizer)

    def _gathered(self, embed, batch: np.ndarray) -> torch.Tensor:
        """``embed(batch)``, or under a mesh this rank's rows of it embedded
        and every rank's rows gathered."""
        if self.mesh is None:
            return embed(batch)
        rows, n = shard_batch(batch, self.mesh)
        return all_gather_rows(embed(rows), self.mesh.data_group)[:n]

    @torch.inference_mode()
    def _embed_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        causal = isinstance(self.model, ClipModel)  # pools each row at its first EOT, the largest id

        def embed(rows):
            if causal:  # no position after the batch's last pooled one reaches an embedding
                eot = rows.argmax(axis=1)
                rows = np.ascontiguousarray(rows[:, :eot.max() + 1])
            profiling.count("h2d_bytes", rows.nbytes)
            if profiling.counting():
                profiling.count("text_rows", len(rows))
                if causal:
                    profiling.count("positions", rows.size)
                    profiling.count("eot_positions", int(eot.sum()) + len(rows))
            t = torch.from_numpy(rows).to(self.device, non_blocking=True).long()
            return _l2_normalize(self.model.encode_text(t))

        with profiling.span("embed.texts"):
            return self._gathered(embed, tokens)

    @torch.inference_mode()
    def _embed_images(self, images_u8: np.ndarray) -> torch.Tensor:
        size = self.cfg.image_resolution

        def embed(rows):
            profiling.count("image_rows", len(rows))
            return _l2_normalize(self.model.encode_image(
                preprocess_device(rows, size=size, device=self.device, **self._pp_kwargs)))

        with profiling.span("embed.images"):
            if not self._calibrated:  # int8_static: scales from the first whole batch, then fixed
                calibrate_act_scales(self.model, pixels=preprocess_device(images_u8, size=size, device=self.device,
                                                                          **self._pp_kwargs))
                self._calibrated = True
            return self._gathered(embed, images_u8)

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
            images = split.images
            h.update(str(images.shape).encode())
            fp = getattr(images, "fingerprint", None)
            token = fp() if fp is not None else None
            if token is not None:  # a procedural source: its generator's parameters
                h.update(token.encode())
            elif is_lazy_store(images):  # a store beyond RAM: a strided 64-row sample
                h.update(np.ascontiguousarray(images[np.linspace(0, len(images) - 1, min(64, len(images)),
                                                                  dtype=np.int64)]).tobytes())
            else:
                h.update(np.ascontiguousarray(images).tobytes())
        h.update(self.weights_fingerprint.encode())
        h.update(repr(self.model.precision).encode())
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
                        img, txt = blob["img"], blob["txt"]
                    ClipEncoder.npz_hits += 1
                    return img, txt
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
