"""Run-output contract utilities (port of lemon_tpu/core/io.py).

- ``args.json``  dumped with Path/numpy-safe encoding (run_lemon.py:86-87)
- ``out.txt`` / ``err.txt`` via a stdout/stderr Tee (lib/utils/utils.py:42-54)
- ``done`` marker written only on success (run_lemon.py:435-436)
- ``EarlyStopping``, the trainers' best-metric tracker
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path, PurePath

import numpy as np
import torch


class Tee:
    """Duplicate a stream to a file (reference: lib/utils/utils.py:42-54)."""

    def __init__(self, fname, mode: str = "a", stream=None):
        self.stream = stream if stream is not None else sys.stdout
        self.file = open(fname, mode)

    def write(self, message):
        self.stream.write(message)
        self.file.write(message)
        self.flush()

    def flush(self):
        self.stream.flush()
        self.file.flush()

    def close(self):
        self.file.close()


def json_default(obj):
    """JSON encoder covering Path and numpy scalar/array types
    (path_serial + NumpyEncoder, lib/utils/utils.py:12-16,91-116)."""
    if isinstance(obj, PurePath):
        return str(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.complexfloating):
        return {"real": obj.real, "imag": obj.imag}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.void):
        return None
    raise TypeError(f"Object of type '{type(obj).__name__}' is not JSON serializable")


def dump_args(out_dir: Path, args: dict) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "args.json", "w") as f:
        json.dump(args, f, default=json_default)


def mark_done(out_dir: Path) -> None:
    with open(Path(out_dir) / "done", "w") as f:
        f.write("done")


def redirect_output(out_dir: Path) -> None:
    """Tee stdout/stderr into ``out.txt``/``err.txt``. The caller that needs
    its streams back restores ``sys.stdout``/``sys.stderr`` itself."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sys.stdout = Tee(out_dir / "out.txt", stream=sys.stdout)
    sys.stderr = Tee(out_dir / "err.txt", stream=sys.stderr)


def env_banner(device: torch.device) -> str:
    lines = [
        "Environment:",
        f"\tPython: {sys.version.split(' ')[0]}",
        f"\tPyTorch: {torch.__version__} (CUDA {torch.version.cuda})",
        f"\tDevice: {device}"
        + (f" ({torch.cuda.get_device_name(device)}, {torch.cuda.device_count()} visible)" if device.type == "cuda" else ""),
        f"\tNumPy: {np.__version__}",
        f"\tNode: {os.uname().nodename}",
    ]
    return "\n".join(lines)


def _snapshot(payload):
    """A copy of ``payload`` that later training cannot change: a module's
    ``state_dict`` (buffers included) or a mapping's tensors, cloned."""
    if isinstance(payload, torch.nn.Module):
        payload = payload.state_dict()
    if isinstance(payload, dict):
        return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v for k, v in payload.items()}
    return payload


class EarlyStopping:
    """Track the best validation metric and signal when patience runs out
    (port of lemon_tpu/core/io.py:100; reference lib/utils/utils.py:56-88).

    The payload is a module or its state dict, and the best one is kept as a
    clone: a torch state dict holds the live tensors, which the next update
    would overwrite in place (the JAX payload is an immutable pytree).

    >>> es = EarlyStopping(patience=3, mode="max")
    >>> for epoch in range(n):
    ...     if es.step(val_acc, model):  # True => new best, a clone kept
    ...         ...
    ...     if es.should_stop:
    ...         break
    >>> best_state, best_metric = es.best_payload, es.best
    """

    def __init__(self, patience: int, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.patience = patience
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf
        self.best_payload = None
        self.since_best = 0

    def seed(self, metric, payload) -> None:
        """Set the starting best without consuming patience (e.g. the
        untrained weights, so an entirely non-improving run still returns
        a payload)."""
        self.best = metric
        self.best_payload = _snapshot(payload)
        self.since_best = 0

    def step(self, metric, payload=None) -> bool:
        improved = metric > self.best if self.mode == "max" else metric < self.best
        if improved:
            self.best = metric
            if payload is not None:
                # an improving step without a payload keeps the previous
                # snapshot (e.g. seed()'s) rather than clobbering it with None
                self.best_payload = _snapshot(payload)
            self.since_best = 0
        else:
            self.since_best += 1
        return improved

    @property
    def should_stop(self) -> bool:
        return self.since_best >= self.patience
