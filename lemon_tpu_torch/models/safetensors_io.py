"""The safetensors file format, read and written in plain Python and torch.

A ``.safetensors`` file is an 8-byte little-endian header length N, N bytes
of JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` map of strings), then the tensors' raw
little-endian bytes, each at its offsets from the end of the header. This
is what HuggingFace's ``save_pretrained`` writes (``model.safetensors``).
The port reads it itself, so it needs no ``safetensors`` package on the
GPU machine. Covered dtypes: F64, F32, F16, BF16, I64, I32, I16, I8, U8
and BOOL.
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
