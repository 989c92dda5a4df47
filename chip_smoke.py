#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, time, serve, train.

    python3 chip_smoke.py          # from the repo root, on a machine with a CUDA GPU

Phases, each fatal on failure (nothing is caught and carried on):
  1. card and software: the nvidia-smi name and power limit, torch and CUDA
     versions; TF32 is switched off for matmuls and cuDNN.
  2. build the CUDA libraries from gat_recommendation_torch/csrc with nvcc
     (in parallel) and print the build seconds and register counts.
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes (attention B=1, N in {8,16,32,56}, and B=512, N=56;
     scoring B=1 over the full 467,456-row table), plus an integer-valued
     tie case through the full exact top-k. Times of the kernel, the plain
     version and a library yardstick: device time from a CUDA graph of 20
     calls (median of 10 replays), and eager time per call with the host's
     dispatch (median of 30 after warm-up), both from CUDA events.
  4. the serving slice at full width: a seeded optimized Graph Transformer
     (466,865 items, D=256, 2 layers, 2 heads) saved through the port's
     checkpoint, a synthetic 737,716-edge co-occurrence graph, the
     Recommender on cuda behind the stdlib HTTP server, 12 POST /recommend
     requests over all four node buckets, each checked and compared with a
     CPU copy of the port (the plain versions).
  5. the kernels' launch counters over phase 4: 2 attention launches and 1
     scoring launch per request.
  6. a torch.profiler breakdown of the same requests (device busy time,
     idle share, the kernels by device time).
  7. the training kernels against their plain versions on the card, at the
     train shapes: attention forward and backward at B=512, N in {8, 56},
     without dropout and with dropout 0.1 from one seed (the keep bits are
     the same by construction); the sparse and the dense AdamW over the full
     467,456 x 256 table, float32 moments and bfloat16 moments with
     stochastic rounding (moments bit-equal); the score kernel at the eval
     batch of 512. Times, bounds and library yardsticks as in phase 3.
  8. the training slice at full width: seeded synthetic sessions through
     SessionDataset and iterate_batches(batch_size=512), a Trainer epoch of
     6 sparse steps over all four buckets, 6 more sparse steps on one batch
     (the loss must fall), 2 dense steps, all with dropout 0.1, then
     Trainer.evaluate and the eval step's top-20 against the dense oracle;
     with dropout 0, two sparse steps on the card against a CPU copy of the
     port. The launch counters over the counted steps: 2 attention forward,
     2 attention backward and 1 sparse AdamW per sparse step; 2, 2 and 1
     dense AdamW per dense step; 2 attention forward and 1 scoring launch
     per eval batch.
  9. a torch.profiler breakdown of sparse train steps.
 10. a JSON line of every kernel's numbers, then the nvidia-smi line, then
     {"ok": true, "device": {...}} as the last line.

Exits nonzero without a CUDA device, and without the package beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.data.batching import (
    SessionDataset,
    iterate_batches,
    make_grad_index,
    to_device,
)
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.ops import _build
from gat_recommendation_torch.ops.embedding_adamw import (
    embedding_adamw,
    embedding_adamw_reference,
)
from gat_recommendation_torch.ops.score_chunkmax import (
    score_chunkmax,
    score_chunkmax_reference,
)
from gat_recommendation_torch.ops.scoring import dense_topk, full_catalog_topk, select_topk
from gat_recommendation_torch.ops.session_attention import (
    session_attention,
    session_attention_backward,
    session_attention_reference,
)
from gat_recommendation_torch.ops.sparse_adamw import sparse_adamw, sparse_adamw_reference
from gat_recommendation_torch.serving import app
from gat_recommendation_torch.serving.recommender import Recommender
from gat_recommendation_torch.serving.validation import validate_request
from gat_recommendation_torch.train import checkpoint
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import (
    Trainer,
    make_eval_step,
    make_sparse_train_step,
    make_train_step,
)

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores (the kernels use no TF32).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

NUM_ITEMS = 466_865  # the reference catalog
NUM_EDGES = 737_716  # the reference co-occurrence graph's edge count
DIM, HEADS = 256, 2
BUCKETS = (8, 16, 32, 56)
ATTN_TOL = dict(rtol=1e-5, atol=2e-5)  # float32, summation order differs
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)  # float32 dots of 256 terms, |score| ~ 16
SERVE_TOL = 1e-4  # card vs CPU copy, per score
ATTN_GRAD_TOL = dict(rtol=1e-5, atol=2e-5)  # float32 gradients, summation order differs
TABLE_TOL = dict(rtol=1e-6, atol=1e-7)  # AdamW table; the moments must be bit-equal
ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5)
ROWS = 467_456  # padded_rows(NUM_ITEMS)
TRAIN_BATCH, NEGATIVES, DROPOUT = 512, 5, 0.1
NUM_SESSIONS = 4000
# Card vs CPU copy of the port, dropout 0: loss; touched table rows and BatchNorm
# buffers. Where a gradient entry is itself at rounding-noise level, AdamW's
# m / (sqrt(v) + eps) turns its relative error into a share of lr = 1e-3, so the
# row tolerance holds for all but 1 entry in 10,000 and a tenth of lr caps the rest.
TRAIN_LOSS_TOL, TRAIN_ROW_TOL, TRAIN_ROW_CAP = 1e-4, 1e-5, 1e-4

REPLACES = {
    "session_attention": "gat_recommendation_tpu/ops/pallas/session_attention.py:59",
    "session_attention_backward": "gat_recommendation_tpu/ops/pallas/session_attention.py:59",
    "score_chunkmax": "gat_recommendation_tpu/ops/pallas/score_chunkmax.py:57",
    "sparse_adamw": "gat_recommendation_tpu/ops/pallas/sparse_adamw.py:117",
    "embedding_adamw": "gat_recommendation_tpu/ops/pallas/embedding_adamw.py:90",
}
SOURCES = {
    "session_attention": "gat_recommendation_torch/csrc/session_attention.cu",
    "session_attention_backward": "gat_recommendation_torch/csrc/session_attention.cu",
    "score_chunkmax": "gat_recommendation_torch/csrc/score_chunkmax.cu",
    "sparse_adamw": "gat_recommendation_torch/csrc/embedding_adamw.cu",
    "embedding_adamw": "gat_recommendation_torch/csrc/embedding_adamw.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of one eager call of fn, in ms. At small shapes
    the card waits for the host's dispatch, so this is what a caller pays."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of fn, in ms: `calls` calls captured in one
    CUDA graph, the graph replayed `reps` times between CUDA events, the
    median divided by `calls`. The graph takes the host's dispatch out, so
    this is the card's own time (the gaps between kernels included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events) / calls
    del graph
    return ms


def timings(kernel, plain, library, calls: int = 20, reps: int = 10, eager_reps: int = 30) -> dict:
    """Device and eager times of the kernel, its plain version and the library
    call (None where no PyTorch call computes the same function)."""
    return {
        "ms": device_ms(kernel, calls, reps),
        "plain_ms": device_ms(plain, calls, reps),
        "library_ms": None if library is None else device_ms(library, calls, reps),
        "eager_ms": eager_ms(kernel, eager_reps),
        "plain_eager_ms": eager_ms(plain, eager_reps),
        "library_eager_ms": None if library is None else eager_ms(library, eager_reps),
    }


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_attention(B: int, N: int, gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, N, DIM, device=dev, generator=gen) for _ in range(3))
    adj = torch.rand(B, N, N, device=dev, generator=gen) < 0.3
    adj[:, 0, :] = False  # an isolated destination in every session
    got = session_attention(q, k, v, adj, HEADS)
    want = session_attention_reference(q, k, v, adj, HEADS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ATTN_TOL)
    if not torch.all(got[:, 0] == 0):
        raise AssertionError("isolated destinations must output exact zeros")
    err = (got - want).abs().max().item()

    d = DIM // HEADS
    qh, kh, vh = (t.view(B, N, HEADS, d).transpose(1, 2) for t in (q, k, v))
    mask = adj[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = 4 * 4 * B * N * DIM + B * N * N  # q, k, v read, out written; adj
    n_flops = 4 * d * HEADS * int(adj.sum())  # q.k and alpha*v over the edges present
    bound, bound_by = bound_ms(n_bytes, n_flops)
    return {
        "shape": f"B={B} N={N} H={HEADS} d={d}",
        "max_abs_err": err,
        **timings(
            lambda: session_attention(q, k, v, adj, HEADS),
            lambda: session_attention_reference(q, k, v, adj, HEADS),
            lambda: sdpa(qh, kh, vh, attn_mask=mask),
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def check_scoring(gen: torch.Generator, B: int = 1) -> dict:
    """B = 1 with an exclusion mask is the serving call; B = 512 without one
    is the eval step's (timed at a smaller depth: the kernel loops over B)."""
    dev = torch.device("cuda")
    rows = ROWS
    table = torch.randn(rows, DIM, device=dev, generator=gen)
    table[0] = 0.0
    table[NUM_ITEMS:] = 0.0
    sess = torch.randn(B, DIM, device=dev, generator=gen)
    exclude = None
    if B == 1:
        exclude = torch.zeros(rows, dtype=torch.uint8, device=dev)
        exclude[torch.randint(1, NUM_ITEMS, (50,), device=dev, generator=gen)] = 1
        exclude[0] = 1
    got = score_chunkmax(sess, table, NUM_ITEMS, exclude)
    want = score_chunkmax_reference(sess, table, NUM_ITEMS, exclude)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCORE_TOL)
    finite = torch.isfinite(want[0])
    err = max((g[torch.isfinite(w)] - w[torch.isfinite(w)]).abs().max().item() for g, w in zip(got, want))
    s_got, i_got = select_topk(*got, 20)
    s_want, _ = dense_topk(sess, table, 20, NUM_ITEMS, exclude)
    torch.testing.assert_close(s_got, s_want, **SCORE_TOL)
    n_excluded = 0 if exclude is None else int(exclude[:NUM_ITEMS].sum())
    if int(finite.sum()) != B * (NUM_ITEMS - n_excluded):
        raise AssertionError("phantom and excluded columns must be -inf, all others finite")

    n_bytes = 4 * rows * DIM + 4 * B * DIM + (rows if B == 1 else 0) + B * (4 * rows + 4 * rows // 32)
    bound, bound_by = bound_ms(n_bytes, 2 * B * rows * DIM)

    def library():
        scores = torch.matmul(sess, table.T)
        return scores.view(B, -1, 32).amax(-1)

    depth = dict(calls=20, reps=10, eager_reps=30) if B == 1 else dict(calls=2, reps=3, eager_reps=3)
    return {
        "shape": f"B={B} V={rows} D={DIM}",
        "max_abs_err": err,
        **timings(
            lambda: score_chunkmax(sess, table, NUM_ITEMS, exclude),
            lambda: score_chunkmax_reference(sess, table, NUM_ITEMS, exclude),
            library,
            **depth,
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
        "with_selection_eager_ms": eager_ms(
            lambda: select_topk(*score_chunkmax(sess, table, NUM_ITEMS, exclude), 20), depth["eager_reps"]
        ),
    }


def check_ties(gen: torch.Generator) -> None:
    """Entries in {-1, 0, 1}: every score is an exact integer in any order of
    summation, so ties are massive and the kernel's top-k must EQUAL the
    stable dense top-k (lowest index first), at k = 10 and 100."""
    dev = torch.device("cuda")
    rows = 467_456
    table = torch.randint(-1, 2, (rows, DIM), device=dev, generator=gen).float()
    sess = torch.randint(-1, 2, (1, DIM), device=dev, generator=gen).float()
    full, _ = score_chunkmax_reference(sess, table, NUM_ITEMS)
    cut_tied = False
    for k in (10, 100):
        s_got, i_got = select_topk(*score_chunkmax(sess, table, NUM_ITEMS), k)
        s_want, i_want = dense_topk(sess, table, k, NUM_ITEMS)
        if not (torch.equal(i_got, i_want) and torch.equal(s_got, s_want)):
            raise AssertionError(f"tie case k={k}: kernel top-k differs from the stable dense top-k")
        # A tie across the cut: an item left out scores as much as one kept,
        # so only the lowest-index rule decides which one is in the top-k.
        last = s_want[0, -1]
        cut_tied |= int((full[0] == last).sum()) > int((s_want[0] == last).sum())
    if not cut_tied:
        raise AssertionError("tie case has no tie across the cut at any k")


# ---------------------------------------------------------------------------
# Phase 4: the serving slice at full width
# ---------------------------------------------------------------------------


def make_checkpoint(path: Path) -> None:
    gen = torch.Generator().manual_seed(0)
    model = create_model("graph_transformer_optimized", NUM_ITEMS, generator=gen, device="cpu")
    with torch.no_grad():
        model.cached_pe.normal_(generator=gen)
        model.cached_pe[NUM_ITEMS:] = 0.0
        for bn in model.batch_norms:
            bn.mean.normal_(0.0, 0.3, generator=gen)
            bn.var.uniform_(0.5, 2.0, generator=gen)
            bn.scale.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.2, generator=gen)
    checkpoint.save(path, model, epoch=0, best_val_metric=0.0)


def make_edge_arrays(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Random co-occurrence edges between items close in id (offset 1..64),
    canonical (min, max) like the real graph, so sessions drawn from a window
    of ids have induced edges."""
    item_i = rng.integers(1, NUM_ITEMS - 64, NUM_EDGES)
    return item_i, item_i + rng.integers(1, 65, NUM_EDGES)


def make_edges(path: Path, rng: np.random.Generator) -> None:
    np.savetxt(path, np.stack(make_edge_arrays(rng), 1), fmt="%d", delimiter=",",
               header="item_i,item_j", comments="")


def make_sessions(rng: np.random.Generator) -> list[tuple[list[int], int]]:
    """12 sessions, three per node bucket, drawn from windows of nearby ids."""
    out = []
    for n, k in zip((3, 5, 8, 9, 12, 16, 20, 27, 32, 33, 45, 50),
                    (10, 20, 5, 10, 50, 10, 100, 10, 20, 10, 15, 10)):
        start = int(rng.integers(1, NUM_ITEMS - 4 * n))
        items = rng.choice(np.arange(start, start + 2 * n), n, replace=False).tolist()
        out.append((items + items[:2], k))  # repeats do not change the bucket
    return out


def post(url: str, body: dict) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        payload = json.loads(r.read())
        status = r.status
    return status, payload, (time.perf_counter() - t0) * 1e3


def agree(gpu: tuple[list, list], cpu: tuple[list, list]) -> None:
    """Scores within SERVE_TOL; ids equal except where neighbouring CPU scores
    tie within that tolerance (the order of a near-tie may flip)."""
    (g_ids, g_s), (c_ids, c_s) = gpu, cpu
    if len(g_ids) != len(c_ids) or np.max(np.abs(np.subtract(g_s, c_s))) > SERVE_TOL:
        raise AssertionError(f"card and CPU scores differ: {g_s[:5]} vs {c_s[:5]}")
    for p, (a, b) in enumerate(zip(g_ids, c_ids)):
        if a != b:
            near = [c_s[q] for q in (p - 1, p + 1) if 0 <= q < len(c_s)]
            if not any(abs(c_s[p] - s) <= SERVE_TOL for s in near):
                raise AssertionError(f"id {a} vs {b} at rank {p} without a near-tie")


def serve_full_width(workdir: Path) -> dict:
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    make_checkpoint(workdir / "ckpt")
    make_edges(workdir / "graph_edges.csv", rng)
    log(f"[phase 4] checkpoint and {NUM_EDGES} edges written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rec = Recommender(workdir / "ckpt", workdir / "graph_edges.csv", device="cuda")
    cpu = Recommender(workdir / "ckpt", workdir / "graph_edges.csv", device="cpu", warmup=False)
    log(f"[phase 4] recommenders loaded and warmed in {time.perf_counter() - t0:.1f} s")

    app.set_recommender(rec)
    server = app.make_server("127.0.0.1", 0, load_model=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/recommend"
    sessions = make_sessions(rng)
    latencies, server_ms, buckets = [], [], set()
    session_attention.launches = 0
    score_chunkmax.launches = 0
    try:
        for items, k in sessions:
            status, payload, ms = post(url, {"session_items": items, "k": k})
            ids, scores = payload.get("recommendations"), payload.get("scores")
            if status != 200 or len(ids) != k:
                raise AssertionError(f"HTTP {status} / {len(ids or [])} items for k={k}: {payload}")
            if set(ids) & set(items) or 0 in ids or max(ids) >= NUM_ITEMS:
                raise AssertionError("a seen, padding or phantom item was recommended")
            if not all(np.isfinite(scores)) or any(a < b for a, b in zip(scores, scores[1:])):
                raise AssertionError("scores must be finite and descending")
            latencies.append(ms)
            server_ms.append(payload["latency_ms"])
            buckets.add(next(b for b in BUCKETS if len(set(items)) <= b))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.set_recommender(None)
    launches = {
        "session_attention": session_attention.launches,
        "score_chunkmax": score_chunkmax.launches,
    }
    if buckets != set(BUCKETS):
        raise AssertionError(f"requests covered buckets {sorted(buckets)}, want {BUCKETS}")

    requests = [validate_request(_Req(items, k), NUM_ITEMS) for items, k in sessions]
    for v in requests:
        agree(rec.recommend(v), cpu.recommend(v))
    return {
        "requests": len(sessions),
        "launches": launches,
        "http_ms_p50": statistics.median(latencies),
        "http_ms_max": max(latencies),
        "server_ms_p50": statistics.median(server_ms),
        "server_ms_max": max(server_ms),
        "profile": profile_requests(rec, requests),
    }


class _Req:
    def __init__(self, items, k):
        self.session_items, self.k = items, k


def profile_requests(rec: Recommender, requests: list) -> dict:
    """Where a request's time goes: the wall time of `Recommender.recommend`
    over the requests (unprofiled, synchronised by its own readback), and
    from a torch.profiler trace of the same requests the card's busy time
    and its kernels by device time. Idle share = 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for v in requests:
        rec.recommend(v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in requests:
        rec.recommend(v)
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(requests)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for v in requests:
            rec.recommend(v)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows) / len(requests)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_us / 1e3 if rows else "not measured",
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms if rows else "not measured",
        "device_ops_per_request": sum(e.count for e in rows) / len(requests),
        "top_device_ms_per_request": {
            e.key[:80]: e.self_device_time_total / 1e3 / len(requests) for e in top
        },
    }


# ---------------------------------------------------------------------------
# Phase 7: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def check_attention_training(B: int, N: int, dropout_p: float, gen: torch.Generator) -> dict:
    """Forward and backward at a train shape. With dropout the kernels and the
    plain version draw the same keep bits from the same seed, so the same
    tolerances hold. Returns the forward's row and the backward's row."""
    dev = torch.device("cuda")
    q, k, v, dout = (torch.randn(B, N, DIM, device=dev, generator=gen) for _ in range(4))
    adj = torch.rand(B, N, N, device=dev, generator=gen) < 0.3
    adj[:, 0, :] = False  # an isolated destination in every session
    seed = 0x5EED_0000_0000_0001 + N
    results = []
    for fn in (session_attention, session_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, adj, HEADS, dropout_p, seed)
        results.append((out.detach(), *torch.autograd.grad(out, leaves, dout)))
    torch.cuda.synchronize()
    torch.testing.assert_close(results[0][0], results[1][0], **ATTN_TOL)
    for got, want in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(got, want, **ATTN_GRAD_TOL)
    if not all(torch.all(t[:, 0] == 0) for t in results[0][:2]):
        raise AssertionError("isolated destinations must give exact zeros, forward and dq")
    fwd_err = (results[0][0] - results[1][0]).abs().max().item()
    bwd_err = max((g - w).abs().max().item() for g, w in zip(results[0][1:], results[1][1:]))

    d = DIM // HEADS
    edges = int(adj.sum())
    shape = f"B={B} N={N} H={HEADS} d={d} p={dropout_p}"
    fwd_bound = bound_ms(4 * 4 * B * N * DIM + B * N * N, 4 * d * HEADS * edges)
    # backward: q, k, v, dO read, dq, dk, dv written, adj read; five edge products
    # (scores, dO.v, dV, dK, dQ) of 2*d operations each, per head
    bwd_bound = bound_ms(7 * 4 * B * N * DIM + B * N * N, 10 * d * HEADS * edges)
    fwd = {"shape": shape, "max_abs_err": fwd_err, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]}
    bwd = {"shape": shape, "max_abs_err": bwd_err, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]}

    qh, kh, vh, doh = (t.view(B, N, HEADS, d).transpose(1, 2) for t in (q, k, v, dout))
    mask = adj[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def both(fn):
        """Forward plus backward of a differentiable attention, for the versions
        that have no backward of their own to call."""
        def run():
            leaves = [t.detach().requires_grad_(True) for t in fn.inputs]
            return torch.autograd.grad(fn(*leaves), leaves, fn.grad)
        return run

    def plain(a, b, c):
        return session_attention_reference(a, b, c, adj, HEADS, dropout_p, seed)

    def library(a, b, c):
        return sdpa(a, b, c, attn_mask=mask, dropout_p=dropout_p)

    plain.inputs, plain.grad = (q, k, v), dout
    library.inputs, library.grad = (qh, kh, vh), doh
    fwd.update(timings(
        lambda: session_attention(q, k, v, adj, HEADS, dropout_p, seed),
        lambda: plain(q, k, v),
        lambda: library(qh, kh, vh),
    ))
    both_plain, both_library = device_ms(both(plain)), device_ms(both(library))
    bwd.update({
        "ms": device_ms(lambda: session_attention_backward(q, k, v, adj, dout, HEADS, dropout_p, seed)),
        # the plain and library backward: forward plus backward minus the forward
        "plain_ms": both_plain - fwd["plain_ms"],
        "library_ms": both_library - fwd["library_ms"],
        "eager_ms": eager_ms(lambda: session_attention_backward(q, k, v, adj, dout, HEADS, dropout_p, seed)),
    })
    return {"forward": fwd, "backward": bwd}


def _table_state(gen: torch.Generator, moment_dtype: torch.dtype):
    dev = torch.device("cuda")
    table = 0.05 * torch.randn(ROWS, DIM, device=dev, generator=gen)
    mu = (1e-3 * torch.randn(ROWS, DIM, device=dev, generator=gen)).to(moment_dtype)
    nu = (1e-6 * torch.rand(ROWS, DIM, device=dev, generator=gen)).to(moment_dtype)
    return table, mu, nu


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(bits), b.view(bits))


def _fused_adamw_library(w, mu, nu, grad, prepare=None):
    """torch._fused_adamw_ on the same tensors (float32 moments only), or None
    if this PyTorch has no such call. `prepare` runs first inside the timed
    function (the sparse case scatters its rows into the dense gradient)."""
    fused = getattr(torch, "_fused_adamw_", None)
    if fused is None or mu.dtype != torch.float32 or nu.dtype != torch.float32:
        return None
    step = torch.full((), 3.0, device=w.device)

    def run():
        if prepare is not None:
            prepare()
        fused([w], [grad], [mu], [nu], [], [step], lr=ADAMW["lr"], beta1=ADAMW["b1"],
              beta2=ADAMW["b2"], weight_decay=ADAMW["weight_decay"], eps=ADAMW["eps"],
              amsgrad=False, maximize=False)

    try:
        run()
        torch.cuda.synchronize()
    except (TypeError, RuntimeError) as e:  # a private call: its signature may differ
        log(f"[phase 7] no library yardstick: torch._fused_adamw_ refused the call ({e})")
        return None
    return run


def check_sparse_adamw(gen: torch.Generator, moment_dtype: torch.dtype, stochastic: bool) -> dict:
    """Full width, U = 16384 slots: 12,000 unique rows (row 0 among them, its
    summed row zeroed as the train step does) and a sentinel tail."""
    dev = torch.device("cuda")
    U, n_unique = 16384, 12000
    table, mu, nu = _table_state(gen, moment_dtype)
    ids = torch.randperm(NUM_ITEMS - 1, device=dev, generator=gen)[: n_unique - 1] + 1
    uid = torch.full((U,), 2**31 - 1, dtype=torch.int32, device=dev)
    uid[:n_unique] = torch.cat([torch.zeros(1, device=dev, dtype=torch.long), ids.sort().values]).int()
    summed = 1e-3 * torch.randn(U, DIM, device=dev, generator=gen)
    summed[0] = 0.0
    summed[n_unique:] = 0.0
    got = [t.clone() for t in (table, mu, nu)]
    want = [t.clone() for t in (table, mu, nu)]
    for count in (1, 2, 3):
        sparse_adamw(*got, uid, summed, count, stochastic_rounding=stochastic, **ADAMW)
        sparse_adamw_reference(*want, uid, summed, count, stochastic_rounding=stochastic, **ADAMW)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    if not (_same_bits(got[1], want[1]) and _same_bits(got[2], want[2])):
        raise AssertionError("sparse_adamw: the kernel's moments differ from the plain version's bits")
    if torch.equal(got[0], table):
        raise AssertionError("sparse_adamw: the table must move")
    err = (got[0] - want[0]).abs().max().item()

    m_bytes = 2 if moment_dtype == torch.bfloat16 else 4
    n_bytes = 2 * ROWS * DIM * (4 + 2 * m_bytes) + 4 * U + 4 * n_unique * DIM
    bound, bound_by = bound_ms(n_bytes, 14 * ROWS * DIM)
    grad = torch.zeros_like(table)
    rows = uid[:n_unique].long()

    def scatter():
        grad.zero_()
        grad.index_add_(0, rows, summed[:n_unique])

    return {
        "shape": f"V={ROWS} D={DIM} U={U} unique={n_unique} moments={str(moment_dtype).split('.')[-1]}"
                 f"{'+sr' if stochastic else ''}",
        "max_abs_err": err,
        **timings(
            lambda: sparse_adamw(*got, uid, summed, 3, stochastic_rounding=stochastic, **ADAMW),
            lambda: sparse_adamw_reference(*want, uid, summed, 3, stochastic_rounding=stochastic, **ADAMW),
            _fused_adamw_library(*[t.clone() for t in (table, mu, nu)], grad, scatter),
            calls=10, reps=5, eager_reps=10,
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def check_embedding_adamw(gen: torch.Generator, moment_dtype: torch.dtype, stochastic: bool) -> dict:
    dev = torch.device("cuda")
    table, mu, nu = _table_state(gen, moment_dtype)
    grad = 1e-3 * torch.randn(ROWS, DIM, device=dev, generator=gen)
    grad[0] = 0.0
    got = [t.clone() for t in (table, mu, nu)]
    want = [t.clone() for t in (table, mu, nu)]
    for count in (1, 2, 3):
        embedding_adamw(*got, grad, count, stochastic_rounding=stochastic, **ADAMW)
        embedding_adamw_reference(*want, grad, count, stochastic_rounding=stochastic, **ADAMW)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    if not (_same_bits(got[1], want[1]) and _same_bits(got[2], want[2])):
        raise AssertionError("embedding_adamw: the kernel's moments differ from the plain version's bits")
    err = (got[0] - want[0]).abs().max().item()
    m_bytes = 2 if moment_dtype == torch.bfloat16 else 4
    n_bytes = ROWS * DIM * (3 * 4 + 4 * m_bytes)  # w and grad read, w written; mu, nu read and written
    bound, bound_by = bound_ms(n_bytes, 16 * ROWS * DIM)
    return {
        "shape": f"V={ROWS} D={DIM} moments={str(moment_dtype).split('.')[-1]}{'+sr' if stochastic else ''}",
        "max_abs_err": err,
        **timings(
            lambda: embedding_adamw(*got, grad, 3, stochastic_rounding=stochastic, **ADAMW),
            lambda: embedding_adamw_reference(*want, grad, 3, stochastic_rounding=stochastic, **ADAMW),
            _fused_adamw_library(*[t.clone() for t in (table, mu, nu)], grad),
            calls=10, reps=5, eager_reps=10,
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


# ---------------------------------------------------------------------------
# Phase 8: the training slice at full width
# ---------------------------------------------------------------------------


def make_dataset(rng: np.random.Generator) -> SessionDataset:
    """Seeded synthetic sessions: heavy small-session skew (geometric lengths,
    3..50 events) plus some long ones so that every node bucket fills, items
    drawn from a window of nearby ids so that the graph's edges are induced."""
    lengths = np.clip(rng.geometric(0.25, NUM_SESSIONS) + 2, 3, 50)
    lengths[: NUM_SESSIONS // 4] = rng.integers(12, 51, NUM_SESSIONS // 4)
    total = int(lengths.sum())
    sid = np.repeat(np.arange(NUM_SESSIONS), lengths)
    start = np.repeat(rng.integers(1, NUM_ITEMS - 200, NUM_SESSIONS), lengths)
    items = start + rng.integers(0, 120, total)
    return SessionDataset(
        (sid, np.arange(total), items), make_edge_arrays(rng),
        num_negatives=NEGATIVES, num_items=NUM_ITEMS,
    )


def make_training_model(dropout: float, device=None):
    """The optimized Graph Transformer at full width, seeded; on the card unless told otherwise."""
    dev = torch.device("cuda" if device is None else device)
    gen = torch.Generator(dev).manual_seed(0)
    model = create_model("graph_transformer_optimized", NUM_ITEMS, dropout=dropout, device=device,
                         generator=gen)
    with torch.no_grad():
        model.cached_pe.normal_(generator=gen)
        model.cached_pe[NUM_ITEMS:] = 0.0
    return model


def launch_counts() -> dict:
    return {
        "session_attention": session_attention.launches,
        "session_attention_backward": session_attention.backward_launches,
        "score_chunkmax": score_chunkmax.launches,
        "sparse_adamw": sparse_adamw.launches,
        "embedding_adamw": embedding_adamw.launches,
    }


def reset_launch_counts() -> None:
    session_attention.launches = session_attention.backward_launches = 0
    score_chunkmax.launches = sparse_adamw.launches = embedding_adamw.launches = 0


def expect_launches(what: str, **want) -> dict:
    got = launch_counts()
    want = {**dict.fromkeys(got, 0), **want}
    if got != want:
        raise AssertionError(f"{what}: launch counts {got}, want {want}")
    return got


def near_tie_agree(got, want, tol: float) -> None:
    """Top-k (scores, ids) of two exact selectors: scores within tol; ids equal
    except where neighbouring oracle scores tie within tol."""
    (g_s, g_i), (w_s, w_i) = got, want
    if (g_s - w_s).abs().max().item() > tol:
        raise AssertionError("eval top-k scores differ from the dense oracle's")
    gap = (w_s[:, :-1] - w_s[:, 1:]).abs() <= tol
    pad = torch.zeros_like(gap[:, :1])
    tied = torch.cat([gap, pad], 1) | torch.cat([pad, gap], 1)
    if bool(((g_i != w_i) & ~tied).any()):
        raise AssertionError("eval top-k ids differ from the dense oracle's without a near-tie")


def train_full_width() -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    dataset = make_dataset(rng)
    batches = list(iterate_batches(dataset, TRAIN_BATCH, shuffle=True, seed=0))
    by_bucket = {n: [b for b in batches if b.nodes_per_session == n] for n in BUCKETS}
    if not all(by_bucket.values()):
        raise AssertionError(f"batches cover buckets {[n for n in BUCKETS if by_bucket[n]]}, want {BUCKETS}")
    log(f"[phase 8] {len(dataset)} sessions, {len(batches)} batches of {TRAIN_BATCH} "
        f"({ {n: len(v) for n, v in by_bucket.items()} }) assembled in {time.perf_counter() - t0:.1f} s")
    epoch = [by_bucket[n][0] for n in BUCKETS] + [by_bucket[8][-1], by_bucket[16][-1]]
    loss_fn = create_loss_function("dual")
    model = make_training_model(DROPOUT)
    if model.item_embedding.device.type != "cuda":
        raise AssertionError("create_model without a device must allocate on the card")
    torch.cuda.synchronize()

    # The counted main path: Trainer epoch (sparse), repeated-batch steps, dense
    # Trainer epoch, evaluation.
    reset_launch_counts()
    trainer = Trainer(model, lambda e: iter(epoch), lambda: iter([by_bucket[56][0]]),
                      loss_fn=loss_fn, seed=7, sparse_embedding_grads=True)
    opt_state = trainer.init_state(reset_parameters=False)
    t0 = time.perf_counter()
    epoch_loss = trainer.train_epoch()
    epoch_s = time.perf_counter() - t0
    if not np.isfinite(epoch_loss):
        raise AssertionError(f"sparse epoch loss {epoch_loss}")
    n_sparse = len(epoch)
    expect_launches("sparse Trainer epoch", session_attention=2 * n_sparse,
                    session_attention_backward=2 * n_sparse, sparse_adamw=n_sparse)

    step = make_sparse_train_step(model, loss_fn, trainer.optimizer, opt_state)
    repeated = to_device((by_bucket[16][0], make_grad_index(by_bucket[16][0])), dev)
    losses = [step(repeated, seed=100 + i).item() for i in range(6)]
    if not all(np.isfinite(losses)) or not losses[5] < losses[0]:
        raise AssertionError(f"repeated-batch losses must be finite and fall: {losses}")
    n_sparse += 6
    expect_launches("sparse steps", session_attention=2 * n_sparse,
                    session_attention_backward=2 * n_sparse, sparse_adamw=n_sparse)

    dense = Trainer(model, lambda e: iter([by_bucket[8][0], by_bucket[56][0]]), lambda: iter(()),
                    optimizer=trainer.optimizer, loss_fn=loss_fn, seed=7)
    dense.init_state(reset_parameters=False, opt_state=opt_state)  # the same moments and count
    dense_loss = dense.train_epoch()
    if not np.isfinite(dense_loss) or opt_state["count"] != n_sparse + 2:
        raise AssertionError(f"dense epoch loss {dense_loss}, count {opt_state['count']}")
    expect_launches("sparse and dense steps", session_attention=2 * (n_sparse + 2),
                    session_attention_backward=2 * (n_sparse + 2), sparse_adamw=n_sparse,
                    embedding_adamw=2)

    metrics = trainer.evaluate()
    if set(metrics) != {"recall@10", "ndcg@10", "recall@20", "ndcg@20"} or not all(
        np.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()
    ):
        raise AssertionError(f"evaluate: {metrics}")
    launches = expect_launches(
        "training and one eval batch", session_attention=2 * (n_sparse + 2) + 2,
        session_attention_backward=2 * (n_sparse + 2), sparse_adamw=n_sparse, embedding_adamw=2,
        score_chunkmax=1)

    # Outside the counted path: the eval step against the dense oracle.
    eval_batch = to_device(by_bucket[56][0], dev)
    ids = make_eval_step(model, 20)(eval_batch)
    with torch.no_grad():
        sess = model.eval()(eval_batch)
        table = model.item_embedding
        two_level = full_catalog_topk(sess, table, 20, NUM_ITEMS)
        oracle = dense_topk(sess, table, 20, NUM_ITEMS)
    if not torch.equal(ids, two_level[1]) or ids.shape != (TRAIN_BATCH, 20):
        raise AssertionError("eval step ids differ from full_catalog_topk's")
    near_tie_agree(two_level, oracle, tol=1e-6)
    if not (bool(torch.isfinite(sess).all()) and int(ids.min()) >= 0 and int(ids.max()) < NUM_ITEMS):
        raise AssertionError("eval: session embeddings must be finite, ids inside the catalog")

    return {
        "sparse_steps": n_sparse, "dense_steps": 2, "eval_batches": 1,
        "launches": launches,
        "epoch_loss": epoch_loss, "repeated_batch_losses": losses, "dense_loss": dense_loss,
        "metrics": metrics,
        "sparse_epoch_wall_ms_per_step": epoch_s * 1e3 / len(epoch),
        "cpu_copy": compare_with_cpu_copy([by_bucket[16][0], by_bucket[56][0]], loss_fn),
        "profile": profile_training(model, loss_fn, trainer.optimizer, opt_state, by_bucket, epoch),
    }


def compare_with_cpu_copy(batches: list, loss_fn) -> dict:
    """Dropout 0: two sparse steps on the card against the same steps of a CPU
    copy of the port (the plain versions), from the same weights."""
    card = make_training_model(0.0)
    cpu = make_training_model(0.0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    out = {"loss_diff": 0.0, "row_diff_max": 0.0, "row_diff_q9999": 0.0, "bn_diff": 0.0}
    steps = []
    for model in (card, cpu):
        opt = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5)
        steps.append(make_sparse_train_step(model, loss_fn, opt, opt.init(model)))
    for i, batch in enumerate(batches):
        gidx = make_grad_index(batch)
        device = next(card.parameters()).device
        got = steps[0](to_device((batch, gidx), device), seed=i).item()
        want = steps[1]((batch, to_device(gidx, "cpu")), seed=i).item()
        rows = torch.from_numpy(gidx.uid[gidx.uid != 2**31 - 1].astype(np.int64))
        out["loss_diff"] = max(out["loss_diff"], abs(got - want))
        diff = (
            card.item_embedding.detach()[rows.to(device)].cpu() - cpu.item_embedding.detach()[rows]
        ).abs().flatten()
        q9999 = diff.kthvalue(max(1, int(0.9999 * diff.numel()))).values.item()
        out["row_diff_max"] = max(out["row_diff_max"], diff.max().item())
        out["row_diff_q9999"] = max(out["row_diff_q9999"], q9999)
    for a, b in zip(card.batch_norms, cpu.batch_norms):
        for name in ("mean", "var"):
            out["bn_diff"] = max(out["bn_diff"], (getattr(a, name).cpu() - getattr(b, name)).abs().max().item())
    if (out["loss_diff"] > TRAIN_LOSS_TOL or out["row_diff_q9999"] > TRAIN_ROW_TOL
            or out["row_diff_max"] > TRAIN_ROW_CAP or out["bn_diff"] > TRAIN_ROW_TOL):
        raise AssertionError(f"card and CPU copy of the train step differ: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 9: where a train step's time goes
# ---------------------------------------------------------------------------


def profile_training(model, loss_fn, optimizer, opt_state, by_bucket: dict, epoch: list) -> dict:
    """Sparse train steps at B=512, N=56, batches already on the card: the
    wall time per step (unprofiled, one synchronise at the end), and from a
    torch.profiler trace of the same steps the card's busy time and its
    kernels by device time. Idle share = 1 - busy / wall. Beside it the dense
    step's and the N=8 step's wall, and a warm Trainer epoch over `epoch`
    (host batches: index, pinning and copies included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    sparse = make_sparse_train_step(model, loss_fn, optimizer, opt_state)
    dense = make_train_step(model, loss_fn, optimizer, opt_state)
    on_card = {n: to_device((by_bucket[n][0], make_grad_index(by_bucket[n][0])), dev) for n in (8, 56)}

    def wall_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    walls = {
        "sparse_step_wall_ms_n56": wall_ms(lambda: sparse(on_card[56], seed=1)),
        "sparse_step_wall_ms_n8": wall_ms(lambda: sparse(on_card[8], seed=1)),
        "dense_step_wall_ms_n56": wall_ms(lambda: dense(on_card[56][0], seed=1)),
    }
    warm = Trainer(model, lambda e: iter(epoch), lambda: iter(()), optimizer=optimizer,
                   loss_fn=loss_fn, sparse_embedding_grads=True)
    warm.init_state(reset_parameters=False, opt_state=opt_state)
    walls["trainer_epoch_wall_ms_per_step"] = wall_ms(warm.train_epoch, n=2) / len(epoch)
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            sparse(on_card[56], seed=i)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:12]
    return {
        **walls,
        "sessions_per_s_n56": TRAIN_BATCH / walls["sparse_step_wall_ms_n56"] * 1e3,
        "device_busy_ms_per_sparse_step": busy_ms if rows else "not measured",
        "device_idle_share": 1.0 - busy_ms / walls["sparse_step_wall_ms_n56"] if rows else "not measured",
        "device_ops_per_sparse_step": sum(e.count for e in rows) / steps,
        "top_device_ms_per_sparse_step": {
            e.key[:80]: e.self_device_time_total / 1e3 / steps for e in top
        },
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    # Phase 1
    smi = nvidia_smi()
    log(f"[phase 1] {smi}")
    log(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[phase 1] TF32 set off for matmul and cuDNN: every float32 product is full float32")

    # Phase 2
    seconds = _build.build()
    log(f"[phase 2] kernels built in {seconds:.1f} s")
    for name in _build.KERNELS:
        log_path = _build.library_path(name).with_suffix(".so.log")
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[phase 2] {name}: {line.strip()}")

    # Phase 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = {(B, N): check_attention(B, N, gen) for B, N in [(1, n) for n in BUCKETS] + [(512, 56)]}
    for row in attn.values():
        log(f"[phase 3] session_attention {json.dumps(row)}")
    score = check_scoring(gen)
    log(f"[phase 3] score_chunkmax {json.dumps(score)}")
    check_ties(gen)
    log("[phase 3] integer-valued tie case: kernel top-k equals the stable dense top-k")

    # Phase 4
    with tempfile.TemporaryDirectory() as tmp:
        served = serve_full_width(Path(tmp))
    profiled = served.pop("profile")
    log(f"[phase 4] {json.dumps(served)}")

    # Phase 5
    n = served["requests"]
    launches = served["launches"]
    if launches["session_attention"] != 2 * n or launches["score_chunkmax"] != n:
        raise AssertionError(f"launch counts {launches} over {n} requests, want 2 and 1 per request")
    log(f"[phase 5] launches over {n} requests: {json.dumps(launches)}")

    # Phase 6
    log(f"[phase 6] {json.dumps(profiled)}")

    # Phase 7
    gen = torch.Generator(device="cuda").manual_seed(1)
    train_attn = {}
    for N in (8, 56):
        for p_drop in (0.0, DROPOUT):
            train_attn[(N, p_drop)] = check_attention_training(TRAIN_BATCH, N, p_drop, gen)
            for part, row in train_attn[(N, p_drop)].items():
                log(f"[phase 7] session_attention {part} {json.dumps(row)}")
    adamw = {}
    for label, dtype, stochastic in (("f32", torch.float32, False), ("bf16+sr", torch.bfloat16, True)):
        adamw[("sparse_adamw", label)] = check_sparse_adamw(gen, dtype, stochastic)
        log(f"[phase 7] sparse_adamw {json.dumps(adamw[('sparse_adamw', label)])}")
        adamw[("embedding_adamw", label)] = check_embedding_adamw(gen, dtype, stochastic)
        log(f"[phase 7] embedding_adamw {json.dumps(adamw[('embedding_adamw', label)])}")
        torch.cuda.empty_cache()
    score_eval = check_scoring(gen, B=TRAIN_BATCH)
    log(f"[phase 7] score_chunkmax {json.dumps(score_eval)}")
    torch.cuda.empty_cache()

    # Phase 8
    trained = train_full_width()
    train_profile = trained.pop("profile")
    log(f"[phase 8] {json.dumps(trained)}")
    train_launches = trained["launches"]

    # Phase 9
    log(f"[phase 9] {json.dumps(train_profile)}")

    # Phase 10: one row per kernel and path, every key in every row.
    kernels = []
    for name, path, row, count in (
        ("session_attention", "serving", attn[(1, 56)], launches["session_attention"]),
        ("score_chunkmax", "serving", score, launches["score_chunkmax"]),
        ("session_attention", "training", train_attn[(56, DROPOUT)]["forward"],
         train_launches["session_attention"]),
        ("session_attention_backward", "training", train_attn[(56, DROPOUT)]["backward"],
         train_launches["session_attention_backward"]),
        ("score_chunkmax", "training", score_eval, train_launches["score_chunkmax"]),
        ("sparse_adamw", "training", adamw[("sparse_adamw", "f32")], train_launches["sparse_adamw"]),
        ("embedding_adamw", "training", adamw[("embedding_adamw", "f32")],
         train_launches["embedding_adamw"]),
    ):
        if count < 1:
            raise AssertionError(f"{name} was not launched on the {path} path")
        kernels.append({
            "name": name,
            "path": path,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "shape": row["shape"],
            "launches": count,
            "max_abs_err": row["max_abs_err"],
            "max_err": row["max_abs_err"],
            "ms": row["ms"],
            "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
