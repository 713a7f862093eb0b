"""Timing helpers of the port's probes: CUDA events around launches on the
card, which PyTorch returns from before the device has finished them.

The JAX probes (``benchmarks/_timing.py``) time on the host clock around a
scalar fetch, two-point, because their relay's dispatch-side timing lied;
events on the card need neither."""

from __future__ import annotations

import json
import subprocess

import torch


def require_cuda(name: str) -> torch.device:
    """The CUDA card; raises without one (a probe measures the card only)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def device_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not read"


def cuda_ms(fn, iters: int = 10, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn`` on the card, over ``iters`` calls
    between two events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def chain_ms(step, x0, steps: int = 20) -> float:
    """Milliseconds per step of the serial chain ``x -> step(x)`` from
    ``x0``: each step reads the last one's output, so no step can be skipped
    or overlapped with the next (the JAX probe's ``chain_rate``)."""
    x = step(x0)  # warm up (and build the kernels)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        x = step(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def emit(results: dict) -> dict:
    """Print the probe's results as one JSON line, as the JAX probes end."""
    print(json.dumps(results), flush=True)
    return results
