"""The traced window: torch.profiler over it, and the reduction of its trace.

The profiler records the card's activity only (CUPTI: kernels, copies,
memsets, and the CUDA runtime calls that launched them), not the host's
operators: recording every operator of the pipeline's threads slows the
host-bound training loop by more than half. ``Tracer.arm`` starts the
profiler during the set-up (its first cycle is a warm-up that is thrown away,
so starting CUPTI costs the window nothing); ``begin`` opens the recorded
cycle and notes the host's clock and the stepping thread; ``end`` waits for
the card, notes the clock and closes the cycle. ``read`` exports the trace to
a temporary file, parses it and deletes it. From the trace:

- ``window_s``: the traced window by the host's clock;
- ``busy_s``: the length of the union of the card's activity;
- ``breakdown()``: the ten device operations that took most time, by name,
  and the ten host activities that the longest idle gaps fell in: each gap
  between device activities goes to the innermost CUDA call in progress on
  the stepping thread at the gap's middle (none: Python work or a wait
  outside CUDA); the window's time before the first and after the last
  recorded event is one more gap. The stepping thread is the one that
  launched the most kernels and graphs (the transfer threads copy).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import Counter, defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
NO_OP = "no CUDA call in progress on the stepping thread"
LAUNCHES = ("cudaLaunchKernel", "cudaGraphLaunch")
EDGES = "before the first and after the last recorded event"


class TraceData:
    def __init__(self, events: list, window_s: float):
        def span(e):
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "")

        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        self.device = sorted(span(e) for e in xs if e.get("cat") in DEVICE_CATS)
        host = [e for e in xs if e.get("cat") in HOST_CATS]
        launches = Counter(e.get("tid") for e in host if e.get("name", "").startswith(LAUNCHES))
        tid = launches.most_common(1)[0][0] if launches else None
        self.host = [span(e) for e in host if e.get("tid") == tid]
        recorded = self.device + self.host
        self.w0 = min((a for a, _, _ in recorded), default=0.0)
        self.w1 = max((b for _, b, _ in recorded), default=0.0)
        self.window_s = window_s
        self.busy = self._union()
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6

    def _union(self) -> list:
        out: list = []
        for a, b, _ in self.device:
            a, b = max(a, self.w0), min(b, self.w1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernels(self, pattern) -> list[float]:
        """Seconds of each kernel in the window whose name matches the compiled regex `pattern`."""
        return [(b - a) / 1e6 for a, b, name in self.device if pattern.search(name)]

    def gaps(self) -> list[tuple[float, float]]:
        edges = [self.w0] + [x for ab in self.busy for x in ab] + [self.w1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]

    def _innermost(self, times: list[float]) -> list[str]:
        """For each of the ascending `times`, the name of the innermost host
        operation around it (the stepping thread's operations nest), in one
        sweep over the operations in start order."""
        ops = sorted(self.host, key=lambda e: (e[0], -e[1]))
        stack: list = []
        j, out = 0, []
        for t in times:
            while j < len(ops) and ops[j][0] <= t:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else NO_OP)
        return out

    def breakdown(self) -> dict:
        ops: dict = defaultdict(float)
        for a, b, name in self.device:
            ops[name[:160]] += (min(b, self.w1) - max(a, self.w0)) / 1e6
        idle: dict = defaultdict(float)
        gaps = self.gaps()
        for (a, b), name in zip(gaps, self._innermost([(a + b) / 2 for a, b in gaps])):
            idle[name[:160]] += (b - a) / 1e6
        idle[EDGES] += max(self.window_s - (self.w1 - self.w0) / 1e6, 0.0)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


class Tracer:
    """torch.profiler over the window, on the card."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        fd, self.path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                            on_trace_ready=lambda p: p.export_chrome_trace(self.path))
        self.window_s, self._t0 = 0.0, 0.0

    def arm(self) -> None:
        self.prof.start()

    def begin(self) -> None:
        self.prof.step()
        self._t0 = time.perf_counter()

    def end(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def read(self) -> TraceData:
        try:
            with open(self.path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(self.path)
        return TraceData(events, self.window_s)
