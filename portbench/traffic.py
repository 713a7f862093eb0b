"""The one traffic generator: a detection's dataset from a mix's data file.

A mix (``portbench/traffic/<name>.json``) gives the split sizes, the
images (size, channels, made fresh for each detection or drawn from a pool
that set-up makes), the texts (label prompts over a label file, or
captions of a length range over a word file), the noise and the detection's
settings. Detection ``i`` of seed ``s`` is made from ``(s, i)`` alone:
new labels or captions, new noise and a new order each time, and the same
sizes for every seed (class counts, caption lengths and the number of
flipped rows are fixed; only their order and content are drawn).

Images are smooth random patterns (a low-resolution normal field upsampled
bilinearly, per class for label mixes) plus pixel noise, made on the
device in chunks and copied to the host, where the program reads them.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.weights import torch_seed

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
SPLITS = ("train", "val", "test")
_CHUNK = 1024


class PoolView:
    """Rows ``rows`` of a host image pool, read as (B, H, W, 3) uint8; a
    one-channel pool is widened to three channels as it is read."""

    def __init__(self, pool: np.ndarray, rows: np.ndarray):
        self.pool, self.rows = pool, rows

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx) -> np.ndarray:
        out = self.pool[self.rows[idx]]
        return np.repeat(out, 3, axis=-1) if out.shape[-1] == 1 else out


@dataclasses.dataclass
class SplitData:
    images: object  # (N, H, W, 3) uint8 array or PoolView
    is_mislabel: np.ndarray
    texts: Optional[List[str]] = None  # captions as served (noisy)
    clean_texts: Optional[List[str]] = None
    y_clean: Optional[np.ndarray] = None
    y_noisy: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.is_mislabel)


@dataclasses.dataclass
class Detection:
    index: int
    splits: Dict[str, SplitData]

    @property
    def pairs(self) -> int:
        return sum(len(s) for s in self.splits.values())


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _lines(name: str) -> List[str]:
    """A data file's non-empty lines."""
    return [w for w in (TRAFFIC_DIR / name).read_text().split("\n") if w.strip()]


def _patterns(gen: torch.Generator, n: int, size: int, channels: int, coarse: int, device) -> torch.Tensor:
    """(n, channels, size, size) smooth fields with unit-order values."""
    low = torch.randn(n, channels, coarse, coarse, generator=gen, device=device)
    return F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)


def _to_u8(x: torch.Tensor) -> np.ndarray:
    """(n, C, H, W) values -> (n, H, W, C) uint8 on the host."""
    return torch.clamp(x, 0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()


class Traffic:
    """Detections of one mix for one seed; ``__init__`` is the set-up part
    (label or word lists, class templates, the image pool)."""

    def __init__(self, mix: dict, seed: int, device: torch.device):
        self.mix, self.seed, self.device = mix, seed, device
        img = mix["images"]
        self.size, self.channels = img["size"], img["channels"]
        self.rows = [mix["rows"][s] for s in SPLITS]
        if mix["kind"] == "labels":
            self.labels = self.label_names(mix)
            self.prompt = mix["prompt"]
        else:
            self.words = np.array(_lines(mix["words"]), dtype=object)
        gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
        self.templates = self.pool = None
        if img["source"] == "fresh":  # class templates, one per label
            self.templates = 128 + 50 * _patterns(gen, len(self.labels), self.size, self.channels, 4, device)
        else:
            self.pool = np.empty((img["pool_rows"], self.size, self.size, self.channels), np.uint8)
            for lo in range(0, len(self.pool), _CHUNK):
                n = min(_CHUNK, len(self.pool) - lo)
                x = 128 + 60 * _patterns(gen, n, self.size, self.channels, 14, device)
                x += 12 * torch.randn(x.shape, generator=gen, device=device)
                self.pool[lo: lo + n] = _to_u8(x)

    @staticmethod
    def label_names(mix: dict) -> List[str]:
        return _lines(mix["labels"])

    def _fresh_images(self, gen: torch.Generator, y: np.ndarray) -> np.ndarray:
        out = np.empty((len(y), self.size, self.size, 3 if self.channels == 1 else self.channels), np.uint8)
        for lo in range(0, len(y), 8 * _CHUNK):
            cls = torch.from_numpy(y[lo: lo + 8 * _CHUNK]).to(self.device)
            x = self.templates[cls]
            x = x + 24 * torch.randn(x.shape, generator=gen, device=self.device)
            out[lo: lo + len(cls)] = _to_u8(x.expand(-1, out.shape[-1], -1, -1))
        return out

    def _captions(self, rng: np.random.Generator, n: int) -> List[str]:
        lo, hi = self.mix["caption_words"]
        lengths = rng.permutation(lo + ((hi - lo + 1) * (np.arange(n) + 0.5) / n).astype(np.int64))
        ids = rng.integers(0, len(self.words), int(lengths.sum()))
        ends = np.cumsum(lengths)
        words = self.words[ids].tolist()
        return [" ".join(words[e - m: e]) for e, m in zip(ends.tolist(), lengths.tolist())]

    def detection(self, index: int, rows: Optional[Sequence[int]] = None) -> Detection:
        """Detection ``index``'s dataset; ``rows`` replaces the mix's split
        sizes (the warm-up's one batch)."""
        rng = np.random.default_rng([self.seed & 0xFFFFFFFFFFFFFFFF, index & 0xFFFFFFFFFFFFFFFF, 7])
        gen = torch.Generator(device=self.device).manual_seed(torch_seed(self.seed, index, 3))
        level = self.mix["noise"]["level"]
        rows = self.rows if rows is None else list(rows)
        total = sum(rows)
        bounds = np.cumsum([0, *rows])
        splits = {}
        if self.mix["kind"] == "labels":
            n_cls = len(self.labels)
            y = rng.permutation(np.arange(total) % n_cls)
            images = self._fresh_images(gen, y)
            for name, a, b in zip(SPLITS, bounds[:-1], bounds[1:]):
                y_clean = y[a:b].astype(np.int64)
                y_noisy = y_clean.copy()
                flip = rng.choice(b - a, int(round(level * (b - a))), replace=False)
                y_noisy[flip] = (y_clean[flip] + rng.integers(1, n_cls, len(flip))) % n_cls
                splits[name] = SplitData(images=images[a:b], is_mislabel=(y_noisy != y_clean).astype(np.int64),
                                         y_clean=y_clean, y_noisy=y_noisy)
        else:
            order = rng.permutation(len(self.pool))[:total]
            if len(order) < total:
                raise ValueError(f"a pool of {len(self.pool)} images for {total} rows")
            for name, a, b in zip(SPLITS, bounds[:-1], bounds[1:]):
                n = b - a
                clean = self._captions(rng, n)
                noisy = list(clean)
                swap = rng.choice(n, int(round(level * n)), replace=False)
                donors = (swap + rng.integers(1, n, len(swap))) % n
                for i, j in zip(swap.tolist(), donors.tolist()):
                    noisy[i] = clean[j]
                mis = np.array([a_ != b_ for a_, b_ in zip(noisy, clean)], np.int64)
                splits[name] = SplitData(images=PoolView(self.pool, order[a:b]), is_mislabel=mis, texts=noisy,
                                         clean_texts=clean)
        return Detection(index=index, splits=splits)

    def texts(self, split: SplitData) -> Sequence[str]:
        """The texts a split pairs with its images, as the reference renders
        them: the label prompts of the noisy labels, or the served captions."""
        if split.texts is not None:
            return split.texts
        return [self.prompt + self.labels[int(i)] for i in split.y_noisy]
