"""Phase timing (port of lemon_tpu/core/profiling.py:24-39) and host spans.

CUDA work is asynchronous, so a host clock around a phase would measure the
enqueue. :class:`PhaseTimer` synchronises the device at both boundaries of a
phase; each phase is also a span (below), so it shows on a
``torch.profiler`` timeline.

:func:`span` records where the host is, without touching the device: a span
is ``(name, id, parent, thread, start_ns, end_ns, counts)`` on
``time.time_ns()``, the clock of the profiler's events, and is also a
``record_function`` range. Spans are recorded only while a
``torch.profiler`` session records on the calling thread (then a device
trace exists to share their clock), or on a thread that :func:`adopt` handed
such a session's context to: the profiler's state is per thread and does not
reach a thread the program starts. Otherwise a span costs one check and
records nothing. A span's parent is the innermost span open on its thread;
:func:`count` adds a number (the bytes uploaded, the rows a tower ran) to
that span, where the work happens; :func:`counting` says whether one would
be added, so that a count that costs work to make is made only then.
Finished spans collect in one buffer per process, read by :func:`spans`
and emptied by :func:`reset`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

from lemon_tpu_torch.core.device import resolve_device, synchronize


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the span open around it on its thread, or the span it was handed (adopt)
    thread: str  # the recording thread's name
    start_ns: int
    end_ns: int
    counts: Dict[str, int]


class _Handoff(NamedTuple):
    parent: Optional[int]


class _ThreadState(threading.local):
    def __init__(self):
        self.open: List["_OpenSpan"] = []  # innermost last
        self.adopted: Optional[_Handoff] = None


_THREAD = _ThreadState()
_SPANS: List[Span] = []
_IDS = itertools.count(1)


def _recording() -> bool:
    return torch.autograd._profiler_enabled() or _THREAD.adopted is not None


def _innermost() -> Optional[int]:
    """The id of the span a new span on this thread hangs under."""
    if _THREAD.open:
        return _THREAD.open[-1].id
    return _THREAD.adopted.parent if _THREAD.adopted is not None else None


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "counts", "start_ns", "_range")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self) -> "_OpenSpan":
        self.parent = _innermost()
        self.id = next(_IDS)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        _THREAD.open.append(self)
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        _THREAD.open.pop()
        self._range.__exit__(*exc)
        _SPANS.append(Span(self.name, self.id, self.parent, threading.current_thread().name, self.start_ns, end_ns,
                           self.counts))


_OFF = contextlib.nullcontext()


def span(name: str, **counts: int):
    """A context manager that records one span named ``name`` with
    ``counts`` (more can be added inside by :func:`count`), or does nothing
    when no profiler session records on this thread."""
    return _OpenSpan(name, counts) if _recording() else _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to the count ``name`` of the innermost span open on this
    thread (nothing when none is open)."""
    stack = _THREAD.open
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def counting() -> bool:
    """Whether :func:`count` on this thread adds to a span (one is open)."""
    return bool(_THREAD.open)


def handoff() -> Optional[_Handoff]:
    """This thread's recording context for a thread it starts: None when it
    records nothing, else the innermost open span, the new thread's parent."""
    return _Handoff(_innermost()) if _recording() else None


def adopt(context: Optional[_Handoff]) -> None:
    """Record this thread's spans under ``context`` (from :func:`handoff`
    on the thread that started it), or record none (None)."""
    _THREAD.adopted = context


def spans() -> List[Span]:
    """The spans finished since the last :func:`reset`, in the order they ended."""
    return list(_SPANS)


def reset() -> None:
    _SPANS.clear()


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
        with span(name):
            yield
            synchronize(self.device)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
