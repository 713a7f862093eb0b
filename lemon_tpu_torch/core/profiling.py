"""Phase timing (port of lemon_tpu/core/profiling.py:24-39).

CUDA work is asynchronous, so a host clock around a phase would measure the
enqueue. :class:`PhaseTimer` synchronises the device at both boundaries of a
phase; each phase is also a ``record_function`` range, so it shows on a
``torch.profiler`` timeline.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

from lemon_tpu_torch.core.device import resolve_device, synchronize


class PhaseTimer:
    def __init__(self, device: Optional[torch.device] = None):
        """``device=None`` is the current CUDA card (``resolve_device("cuda")``,
        which raises without one); pass ``torch.device("cpu")`` to time CPU
        work."""
        self.device = resolve_device("cuda") if device is None else device
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            synchronize(self.device)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
