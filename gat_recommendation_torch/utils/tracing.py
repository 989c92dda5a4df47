"""Spans of the host pipeline, kept in memory.

A span is a named interval of one thread's time: its name, the thread's
native id, its start and end from ``time.perf_counter_ns()``, its parent (the
innermost span open on the same thread when it began) and its ids. The ids
say what the span worked on: ``epoch`` and ``step`` in training (``step``:
the optimizer's count before the step, so every span of one step carries the
same number), ``pass_`` and ``batch`` in evaluation, and on the assembly and
transfer threads ``batch``, the position of the item in the feed it came
from; the stepping thread's ``wait`` for that item carries the same
``batch``. A chained dispatch's ``steps`` is the number of steps or batches
it carries. ``ids(span)`` adds what the span's parents carry.

The sites sit at the layers' boundaries, about ten a training step (the
feed's wait, the step block, the chained or single dispatch, a graph's replay
or capture, a transfer, a batch's assembly), never around single kernels.

Nothing records unless someone reads: spans are kept

- while a ``torch.profiler`` recording is active (its active cycle, not its
  warm-up), into the profiler-keyed recording that ``recorded()`` returns and
  ``take()`` hands over and starts afresh: so a trace of the card and the
  spans of the same window come together;
- inside ``recording()``, into the recording it returns.

While either is on, garbage collections are spans too (``gc``, on the thread
that collected). Off, a site costs one test of two module globals and
returns the one shared ``OFF`` object (falsy; its ``with`` does nothing).
"""

from __future__ import annotations

import gc
import threading
import time

from torch.autograd import profiler as _profiler

# Span names.
EPOCH = "train.epoch"  # Trainer.train_epoch (a root)
WAIT = "wait"  # the stepping thread waits for the feed's next item
TRANSFER = "transfer"  # an item's transfer to the device (transfer threads)
ASSEMBLE = "assemble"  # a batch's assembly (assembly threads, or inline)
BLOCK = "block"  # the step block of the next steps
CHAINED = "chained"  # a chained dispatch of several steps or batches
REPLAY = "replay"  # one CUDA graph's replay: one cudaGraphLaunch
CAPTURE = "capture"  # one CUDA graph's warm-up and capture
SINGLE = "single"  # a single train or eval step's dispatch
READBACK = "readback"  # a readback that waits for the card
PASS = "eval.pass"  # Trainer.evaluate (a root)
COPY = "copy"  # evaluation's stacking and copy of a group to the device
METRICS = "metrics"  # recall and NDCG on the host
GC = "gc"  # a garbage collection
ROOTS = (EPOCH, PASS)


class Recording:
    """What one recording holds: the finished spans, in the order they ended."""

    def __init__(self):
        self.spans: list[Span] = []


class Span:
    """One span, open from ``__enter__`` to ``__exit__`` (a context manager)."""

    __slots__ = ("name", "tid", "start", "end", "parent", "ids", "_into")

    def __init__(self, name: str, ids: dict, into: tuple):
        self.name, self.ids, self._into = name, ids, into
        self.tid = threading.get_native_id()
        self.parent: Span | None = None
        self.start = self.end = 0

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = time.perf_counter_ns()
        _stack().pop()
        for r in self._into:
            r.spans.append(self)
        return False

    def __repr__(self) -> str:
        return f"Span({self.name!r}, tid={self.tid}, {(self.end - self.start) / 1e3:.1f} us, ids={self.ids})"


class _Off:
    """The span of every site while nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


OFF = _Off()

_profiled = Recording()  # the profiler-keyed recording
_recordings: tuple = ()  # the open recording() buffers
_lock = threading.Lock()
_local = threading.local()
_gc_hooked = False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _into() -> tuple:
    return (_profiled, *_recordings) if _profiler._is_profiler_enabled else _recordings


def span(name: str, epoch=None, step=None, pass_=None, batch=None, steps=None):
    """A span named `name` with the ids given (a context manager), or
    ``OFF`` while nothing records. ``steps``: the steps or batches a
    dispatch carries."""
    if not (_profiler._is_profiler_enabled or _recordings):
        if _gc_hooked:
            _set_gc_hook(False)
        return OFF
    if not _gc_hooked:
        _set_gc_hook(True)
    ids = {k: v for k, v in (("epoch", epoch), ("step", step), ("pass_", pass_), ("batch", batch),
                             ("steps", steps)) if v is not None}
    return Span(name, ids, _into())


def ids(s: Span) -> dict:
    """The ids of `s` with those of its parents (its own win)."""
    chain = []
    while s is not None:
        chain.append(s.ids)
        s = s.parent
    out: dict = {}
    for d in reversed(chain):
        out.update(d)
    return out


def recorded() -> Recording:
    """The profiler-keyed recording since the last ``take()``, not cleared."""
    return _profiled


def take() -> Recording:
    """The profiler-keyed recording since the last ``take()``; the next
    profiler recording starts afresh."""
    global _profiled
    out, _profiled = _profiled, Recording()
    return out


class recording:
    """``with recording() as r:`` records every span of the block,
    on every thread, into ``r`` (a ``Recording``)."""

    def __enter__(self) -> Recording:
        global _recordings
        self.buffer = Recording()
        with _lock:
            _recordings = (*_recordings, self.buffer)
        _set_gc_hook(True)
        return self.buffer

    def __exit__(self, *exc) -> bool:
        global _recordings
        with _lock:
            _recordings = tuple(r for r in _recordings if r is not self.buffer)
        if not (_recordings or _profiler._is_profiler_enabled):
            _set_gc_hook(False)
        return False


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        into = _into()
        s = _local.gc = Span(GC, {}, into) if into else None
        if s is not None:
            stack = _stack()
            s.parent = stack[-1] if stack else None
            s.start = time.perf_counter_ns()
        return
    s = getattr(_local, "gc", None)
    if s is not None:
        s.end = time.perf_counter_ns()
        _local.gc = None
        for r in s._into:
            r.spans.append(s)


def _set_gc_hook(on: bool) -> None:
    """Install or remove the collector's callback (``gc.callbacks``)."""
    global _gc_hooked
    with _lock:
        if on and not _gc_hooked:
            gc.callbacks.append(_on_gc)
        elif not on and _gc_hooked:
            gc.callbacks.remove(_on_gc)
        _gc_hooked = on
