"""The safetensors file format, read and written in plain Python and torch.

A ``.safetensors`` file is an 8-byte little-endian header length N, N bytes
of JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` map of strings), then the tensors' raw
little-endian bytes, each at its offsets from the end of the header. This
is what HuggingFace's ``save_pretrained`` writes (``model.safetensors``).
The port reads it itself, so it needs no ``safetensors`` package on the
GPU machine. Covered dtypes: F64, F32, F16, BF16, I64, I32, I16, I8, U8
and BOOL.

A model above ``save_pretrained``'s ``max_shard_size`` is written as
shards, ``model-0000i-of-0000n.safetensors``, beside
``model.safetensors.index.json``, whose ``weight_map`` names each tensor's
shard (``pytorch_model.bin.index.json`` for ``torch.save`` shards).
:func:`load_pretrained` reads a directory in any of the four layouts and
:func:`save_sharded` writes the sharded one.
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
_MAX_HEADER = 100_000_000  # the package's own limit


def _check_byteorder() -> None:
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors_io reads and writes little-endian hosts only")


def read_header(path) -> tuple[dict, int]:
    """(header dict, byte offset of the data) of a safetensors file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header length {n} is out of range")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, bit for bit, on the CPU."""
    _check_byteorder()
    header, start = read_header(path)
    header.pop("__metadata__", None)
    buf = bytearray(Path(path).read_bytes())  # writable: torch.frombuffer shares it
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or start + end > len(buf):
            raise ValueError(f"{path}: tensor {name} has offsets {begin}..{end} for shape {shape}")
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count, offset=start + begin).reshape(shape)
        out[name] = t
    return out


def load_numpy(path) -> Dict[str, np.ndarray]:
    """:func:`load_file` as numpy arrays; BF16 tensors come back as float32
    (numpy has no bfloat16; every bf16 value is exact in float32)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in load_file(path).items()}


def save_file(tensors: Mapping[str, torch.Tensor], path, metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) in
    the safetensors format, in name order, the header padded with spaces to
    a multiple of 8 bytes as the package pads it."""
    _check_byteorder()
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json", "pytorch_model.bin",
                "pytorch_model.bin.index.json")


def _load_one(path: Path) -> Dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_pretrained(checkpoint_dir) -> Dict[str, torch.Tensor]:
    """The state dict of a ``save_pretrained`` directory, on the CPU, from the
    first of :data:`WEIGHT_FILES` that exists (HF's order: safetensors
    before ``torch.save`` files, one file before an index). An index's
    shards are read in turn; a missing shard, or a tensor the index names
    but its shard lacks, raises."""
    d = Path(checkpoint_dir)
    found = next((d / f for f in WEIGHT_FILES if (d / f).exists()), None)
    if found is None:
        raise FileNotFoundError(f"{d}: none of {', '.join(WEIGHT_FILES)}")
    if not found.name.endswith(".index.json"):
        return _load_one(found)
    weight_map = json.loads(found.read_text())["weight_map"]
    out: Dict[str, torch.Tensor] = {}
    for shard in sorted(set(weight_map.values())):
        if not (d / shard).exists():
            raise FileNotFoundError(f"{d}: {found.name} names the shard {shard}, which is missing")
        out.update(_load_one(d / shard))
    lacking = sorted(set(weight_map) - set(out))
    if lacking:
        raise KeyError(f"{d}: {found.name} names tensors that no shard holds: {lacking[:5]}")
    return out


def save_sharded(tensors: Mapping[str, torch.Tensor], out_dir, max_shard_bytes: int,
                 metadata: Optional[Mapping[str, str]] = None) -> list:
    """Write ``tensors`` as ``save_pretrained`` does: ``model.safetensors``
    when they fit in ``max_shard_bytes``, else shards filled in name order
    (a tensor that would overflow the current shard opens the next one; a
    tensor above the limit has a shard of its own) and
    ``model.safetensors.index.json``. Returns the files written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    shards: list = [[]]
    size = 0
    for name in sorted(tensors):
        n = tensors[name].numel() * tensors[name].element_size()
        if shards[-1] and size + n > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += n
    if len(shards) == 1:
        save_file(tensors, out / "model.safetensors", metadata)
        return [out / "model.safetensors"]
    files, weight_map = [], {}
    for i, names in enumerate(shards, 1):
        fname = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
        save_file({n: tensors[n] for n in names}, out / fname, metadata)
        files.append(out / fname)
        weight_map.update(dict.fromkeys(names, fname))
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    index = {"metadata": {"total_size": total, "total_parameters": sum(t.numel() for t in tensors.values())},
             "weight_map": weight_map}
    (out / "model.safetensors.index.json").write_text(json.dumps(index, indent=2, sort_keys=True))
    return files + [out / "model.safetensors.index.json"]
