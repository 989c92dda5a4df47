"""The program's spans in the traced window, on the device trace's clock.

The program records spans (``gat_recommendation_torch/utils/tracing.py``)
while torch.profiler's active cycle runs, which is the traced
window (``trace.py``: ``Tracer.begin`` to ``Tracer.end``), and hands them out
without clearing them (``tracing.recorded()``). A program without the
recorder gives nothing, and its readers return None.

The spans' clock is the host's ``perf_counter_ns``, the trace's its own
microseconds. Each ``replay`` span of the stepping thread (the thread of the
``train.epoch`` and ``eval.pass`` roots) wraps the one ``cudaGraphLaunch`` it
makes. Paired in order with the trace's ``cudaGraphLaunch`` calls on its
stepping thread, a span [a, b] encloses its call [c, d] once shifted by the
offset o (trace us = span us + o): d - b <= o <= c - a for every pair. The
interval [max(d - b), min(c - a)] is then narrowed by the edges of every
span of the stepping thread: an edge is a clock read in Python, between two
CUDA calls of its thread, so no offset may put it inside one of the trace's
calls on that thread. The offset is the middle of what is left and its width
the alignment's error. With another count of replays than of launches, an
empty interval or a width over ``WIDTH_US``, there is no alignment.

A span set's idle time is the part of the trace's idle gaps between device
activities (``TraceData.gaps()``) that the union of those spans covers.
"""

from __future__ import annotations

import bisect
import sys
from collections import Counter

LAUNCH = "cudaGraphLaunch"
ROOTS = ("train.epoch", "eval.pass")
DISPATCHES = ("chained", "single")
WIDTH_US = 50.0  # the widest alignment the readers take
_last: list = [None, None, None]  # the last recording and trace aligned, and what was found


def recorded():
    """The program's recording of the traced window, or None (no recorder,
    or nothing recorded)."""
    try:
        from gat_recommendation_torch.utils import tracing
    except ImportError:
        return None
    rec = tracing.recorded()
    return rec if rec.spans else None


def stepping(rec) -> int | None:
    """The native id of the thread that ran the roots (the stepping thread)."""
    tids = Counter(s.tid for s in rec.spans if s.name in ROOTS)
    return tids.most_common(1)[0][0] if tids else None


def outermost(rec, names, tid=None) -> list:
    """The spans named in `names` (on thread `tid`, where given) that lie
    inside no other span of those names."""
    out = []
    for s in rec.spans:
        if s.name not in names or (tid is not None and s.tid != tid):
            continue
        p = s.parent
        while p is not None and p.name not in names:
            p = p.parent
        if p is None:
            out.append(s)
    return out


def seconds(spans) -> float:
    return sum(s.end - s.start for s in spans) / 1e9


def dispatched(rec, kind: str) -> int:
    """The training steps (`kind` "step") or validation batches ("batch")
    that the stepping thread's dispatches carried: a ``chained`` span its
    ``steps``, a ``single`` span one. Training's dispatches carry a ``step``
    id, evaluation's a ``batch``."""
    if rec is None:
        return 0
    return sum(s.ids.get("steps", 1) for s in outermost(rec, DISPATCHES, stepping(rec)) if kind in s.ids)


def ms_per(rec, names, n: int, on_stepping: bool = True) -> float | None:
    """ms of the outermost spans of `names` (the stepping thread's, or every
    thread's) per one of `n`."""
    if rec is None or not n:
        return None
    tid = stepping(rec) if on_stepping else None
    if on_stepping and tid is None:
        return None
    return 1e3 * seconds(outermost(rec, names, tid)) / n


def align(rec, trace) -> tuple[float, float] | None:
    """(offset, width) in us: trace us = span us + offset, within width; or
    None. Logged once for each recording and trace."""
    if _last[0] is not rec or _last[1] is not trace:
        tid = stepping(rec)
        mine = [s for s in rec.spans if s.tid == tid]
        replays = sorted((s.start / 1e3, s.end / 1e3) for s in mine if s.name == "replay")
        launches = sorted((a, b) for a, b, name in trace.host if name == LAUNCH)
        found, why = None, f"{len(replays)} replay spans, {len(launches)} {LAUNCH} calls"
        if replays and len(replays) == len(launches):
            lo = max(d - b for (a, b), (c, d) in zip(replays, launches))
            hi = min(c - a for (a, b), (c, d) in zip(replays, launches))
            if lo <= hi:
                left = between_calls(lo, hi, mine, trace.host)
                if left is None:
                    why += f": every offset of the replays' {hi - lo:.3f} us puts a span's edge inside a call"
                elif left[1] - left[0] > WIDTH_US:
                    why += f": width {left[1] - left[0]:.3f} us, over {WIDTH_US:g}"
                else:
                    found = ((left[0] + left[1]) / 2, left[1] - left[0])
                    why += f"; the replays alone {hi - lo:.3f} us, with {2 * len(mine)} span edges"
        if found is None:
            print(f"spans: no alignment with the trace ({why})", file=sys.stderr, flush=True)
        else:
            print(f"spans: offset {found[0]:.3f} us, width {found[1]:.3f} us ({why})", file=sys.stderr, flush=True)
        _last[:] = [rec, trace, found]
    return _last[2]


def between_calls(lo: float, hi: float, spans, calls) -> tuple[float, float] | None:
    """The offsets of [lo, hi] that put no edge of `spans` strictly inside
    one of `calls` ((start, end, name) in trace us): the hull of the pieces
    of [lo, hi] left, or None where none is (single points do not count,
    unless lo equals hi)."""
    busy: list = []  # the calls' union, sorted and disjoint
    for a, b in sorted((a, b) for a, b, _ in calls if b > a):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    starts = [a for a, _ in busy]
    cuts = []  # offsets (open intervals) that put an edge inside a call
    for s in spans:
        for t in (s.start / 1e3, s.end / 1e3):
            j = bisect.bisect_left(starts, t + hi)
            while j > 0 and busy[j - 1][1] > t + lo:
                j -= 1
                cuts.append((busy[j][0] - t, busy[j][1] - t))
    left, x = [], lo
    for a, b in sorted(cuts):
        if a > x:
            left.append((x, min(a, hi)))
        x = max(x, b)
        if x >= hi:
            break
    if x < hi or lo == hi == x:
        left.append((x, hi))
    return (left[0][0], left[-1][1]) if left else None


def in_trace_us(spans, offset: float) -> list[tuple[float, float]]:
    """The spans' intervals on the trace's clock."""
    return [(s.start / 1e3 + offset, s.end / 1e3 + offset) for s in spans]


def covered_s(gaps, intervals) -> float:
    """Seconds of the sorted, disjoint `gaps` (us) that the union of `intervals` (us) covers."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total, j = 0.0, 0
    for a, b in gaps:
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            total += min(b, merged[k][1]) - max(a, merged[k][0])
            k += 1
    return total / 1e6


def idle_share_under(obs, names, idle_share: float | None) -> float | None:
    """% of the measured window in which the card idles while the stepping
    thread is inside the outermost spans of `names`: `idle_share` (the
    untraced window's idle %) times the traced window's idle time those
    spans cover over the traced window's idle time (window_s - busy_s)."""
    rec, trace = recorded(), obs["trace"]
    if rec is None or trace is None or idle_share is None or trace.window_s <= trace.busy_s:
        return None
    clock = align(rec, trace)
    if clock is None:
        return None
    spans = outermost(rec, names, stepping(rec))
    return idle_share * covered_s(trace.gaps(), in_trace_us(spans, clock[0])) / (trace.window_s - trace.busy_s)


def untraced_idle_share(obs, kind: str) -> float | None:
    """The cell's ``idle_share.<kind>`` as its own reader reads it."""
    from benchmark import harness

    return harness.load_module(harness.HERE / "metrics" / f"idle_share.{kind}.py").read(obs)
