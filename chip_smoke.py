#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, time, serve.

    python3 chip_smoke.py          # from the repo root, on a machine with a CUDA GPU

Phases, each fatal on failure (nothing is caught and carried on):
  1. card and software: the nvidia-smi name and power limit, torch and CUDA
     versions; TF32 is switched off for matmuls and cuDNN.
  2. build both CUDA kernels from gat_recommendation_torch/csrc with nvcc
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
  7. a JSON line of every kernel's numbers, then the nvidia-smi line, then
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

from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.ops import _build
from gat_recommendation_torch.ops.score_chunkmax import (
    score_chunkmax,
    score_chunkmax_reference,
)
from gat_recommendation_torch.ops.scoring import dense_topk, select_topk
from gat_recommendation_torch.ops.session_attention import (
    session_attention,
    session_attention_reference,
)
from gat_recommendation_torch.serving import app
from gat_recommendation_torch.serving.recommender import Recommender
from gat_recommendation_torch.serving.validation import validate_request
from gat_recommendation_torch.train import checkpoint

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

REPLACES = {
    "session_attention": "gat_recommendation_tpu/ops/pallas/session_attention.py:59",
    "score_chunkmax": "gat_recommendation_tpu/ops/pallas/score_chunkmax.py:57",
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


def timings(kernel, plain, library) -> dict:
    """Device and eager times of the kernel, its plain version and the library call."""
    return {
        "ms": device_ms(kernel),
        "plain_ms": device_ms(plain),
        "library_ms": device_ms(library),
        "eager_ms": eager_ms(kernel),
        "plain_eager_ms": eager_ms(plain),
        "library_eager_ms": eager_ms(library),
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


def check_scoring(gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    rows = 467_456  # padded_rows(466,865)
    table = torch.randn(rows, DIM, device=dev, generator=gen)
    table[0] = 0.0
    table[NUM_ITEMS:] = 0.0
    sess = torch.randn(1, DIM, device=dev, generator=gen)
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
    if int(finite.sum()) != NUM_ITEMS - int(exclude[:NUM_ITEMS].sum()):
        raise AssertionError("phantom and excluded columns must be -inf, all others finite")

    n_bytes = 4 * rows * DIM + 4 * DIM + rows + 4 * rows + 4 * rows // 32
    bound, bound_by = bound_ms(n_bytes, 2 * rows * DIM)

    def library():
        scores = torch.matmul(sess, table.T)
        return scores.view(1, -1, 32).amax(-1)

    return {
        "shape": f"B=1 V={rows} D={DIM}",
        "max_abs_err": err,
        **timings(
            lambda: score_chunkmax(sess, table, NUM_ITEMS, exclude),
            lambda: score_chunkmax_reference(sess, table, NUM_ITEMS, exclude),
            library,
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
        "with_selection_eager_ms": eager_ms(
            lambda: select_topk(*score_chunkmax(sess, table, NUM_ITEMS, exclude), 20)
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
    model = create_model("graph_transformer_optimized", NUM_ITEMS, generator=gen)
    with torch.no_grad():
        model.cached_pe.normal_(generator=gen)
        model.cached_pe[NUM_ITEMS:] = 0.0
        for bn in model.batch_norms:
            bn.mean.normal_(0.0, 0.3, generator=gen)
            bn.var.uniform_(0.5, 2.0, generator=gen)
            bn.scale.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.2, generator=gen)
    checkpoint.save(path, model, epoch=0, best_val_metric=0.0)


def make_edges(path: Path, rng: np.random.Generator) -> None:
    """Random co-occurrence edges between items close in id (offset 1..64),
    canonical (min, max) like the real graph, so sessions drawn from a window
    of ids have induced edges."""
    item_i = rng.integers(1, NUM_ITEMS - 64, NUM_EDGES)
    item_j = item_i + rng.integers(1, 65, NUM_EDGES)
    np.savetxt(path, np.stack([item_i, item_j], 1), fmt="%d", delimiter=",",
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
    kernels = []
    for name, row, source in (
        ("session_attention", attn[(1, 56)], "gat_recommendation_torch/csrc/session_attention.cu"),
        ("score_chunkmax", score, "gat_recommendation_torch/csrc/score_chunkmax.cu"),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": REPLACES[name],
            "shape": row["shape"],
            "launches": launches[name],
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
