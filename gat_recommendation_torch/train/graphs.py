"""CUDA graphs of the chained train and eval steps.

A step's host code dispatches some 350 device operations from Python. A
graph records them once and a replay launches them all with the host out of
the way. What changes from step to step reaches the recorded kernels through
device memory: the batch and its index through static input buffers that the
host refills before each replay, the count, the bias corrections and the
seeds through the step block (``ops/step_block.py``). A graph holds the
addresses of everything it touches, so a new optimizer state needs new graphs.

Capture runs the step once for real first, on the capture stream (a warm-up:
libraries load, cuBLAS takes its workspace, kernels load on first launch),
then records it. Both move the training state, so the state is copied before
the warm-up and copied back after it, and the host's side effects are put
back as well: the optimizer's count and the wrappers' launch counters. A
replay adds to each launch counter what the capture counted, so the counters
count per step run, as in the eager loop. A capture that fails raises: there
is no eager fallback on the card. A capture holds ``device.capture_lock``,
which every host-to-device transfer takes for its CUDA calls, so the prefetch
thread of an epoch (``data/batching.prefetch_to_device``) pauses while a graph
is recorded.

The graphs of one cache share one memory pool. That is safe here because a
cache's graphs never run at once and every graph's output is copied out (or
read) before another graph of the cache replays.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from gat_recommendation_torch.device import capture_lock
from gat_recommendation_torch.ops import (
    embedding_adamw,
    lazy_adamw,
    node_dropout,
    score_chunkmax,
    session_attention,
    sparse_adamw,
)

# Every wrapper's launch counter, as (function, attribute).
COUNTERS = (
    (session_attention.session_attention, "launches"),
    (session_attention.session_attention, "staged_launches"),
    (session_attention.session_attention, "backward_launches"),
    (score_chunkmax.score_chunkmax, "launches"),
    (score_chunkmax.score_chunkmax, "tile_launches"),
    (sparse_adamw.sparse_adamw, "launches"),
    (embedding_adamw.embedding_adamw, "launches"),
    (lazy_adamw.gather_catch_up, "launches"),
    (lazy_adamw.touched_update_scatter, "launches"),
    (lazy_adamw.materialize, "launches"),
    (node_dropout.node_dropout, "launches"),
)


def read_counters() -> list[int]:
    return [getattr(fn, name) for fn, name in COUNTERS]


def write_counters(values: list[int]) -> None:
    for (fn, name), value in zip(COUNTERS, values):
        setattr(fn, name, value)


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]  # the static input buffers, refilled before each replay
    output: torch.Tensor
    launches: list[int]  # what one replay adds to each launch counter


class GraphCache:
    """The captured graphs of one step function, by shape key.

    ``fn(*inputs)`` reads its input tensors and the training state, writes
    only the state and returns one tensor. `state` returns the tensors it
    writes in place (None: it writes nothing); `host` is the optimizer state
    whose ``count`` it advances on the host (None: no such dict).
    """

    def __init__(self, fn: Callable, state: Callable[[], list] | None = None, host: dict | None = None):
        self.fn = fn
        self.state = state
        self.host = host
        self.graphs: dict = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream()
        self.capture_seconds = 0.0
        self.pool_bytes = 0  # device memory the captures reserved: the pool's segments

    def run(self, key, inputs: list[torch.Tensor]) -> torch.Tensor:
        """Copy `inputs` into the graph of `key` and replay it; the first call
        of a key captures its graph on these inputs. Returns the graph's output
        buffer, which the next replay of this cache may overwrite."""
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture([t.clone() for t in inputs])
        else:
            for buffer, t in zip(entry.inputs, inputs):
                buffer.copy_(t)
        entry.graph.replay()
        write_counters([n + d for n, d in zip(read_counters(), entry.launches)])
        return entry.output

    def _capture(self, inputs: list[torch.Tensor]) -> _Graph:
        start = time.perf_counter()
        counters = read_counters()
        count = None if self.host is None else self.host["count"]
        saved = None if self.state is None else [t.detach().clone() for t in self.state()]
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            self.fn(*inputs)  # the warm-up: one real step on the real state
        torch.cuda.current_stream().wait_stream(self.stream)
        if saved is not None:
            with torch.no_grad():
                for t, s in zip(self.state(), saved):
                    t.copy_(s)
            del saved
        self._put_back(counters, count)
        graph = torch.cuda.CUDAGraph()
        # Capture starts by releasing the allocator's unused blocks; release
        # them first, so that what capture reserves is the pool's growth.
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        # capture_lock: no transfer on another thread makes a CUDA call while
        # the capture records (the default "global" capture mode forbids it).
        with capture_lock, torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            output = self.fn(*inputs)
        self.pool_bytes += torch.cuda.memory_reserved() - reserved
        launches = [after - before for before, after in zip(counters, read_counters())]
        self._put_back(counters, count)
        self.capture_seconds += time.perf_counter() - start
        return _Graph(graph, inputs, output, launches)

    def _put_back(self, counters: list[int], count: int | None) -> None:
        write_counters(counters)
        if self.host is not None:
            self.host["count"] = count
