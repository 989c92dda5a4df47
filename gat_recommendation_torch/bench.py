"""End-to-end training throughput of the port (sessions/s on one GPU), the flagship model.

    python3 -m gat_recommendation_torch.bench                 # on a machine with a CUDA GPU
    python3 -m gat_recommendation_torch.bench --sessions 30000 --epochs 2 --chain 1

The default run measures the real training pipeline over full epochs of a
reference-scale corpus (120,436 sessions over a 466,865-item catalog, the
co-occurrence graph built by ``data/graph.build_co_event_graph``): host batch
assembly by the C++ engine on a thread pool (``--workers``), the sparse
step's ``GradIndex``, stacking a chain's group, the copies to the card on a
side stream (``prefetch_to_device``, ``--transfer-workers``), and the lazy
sparse train step, chained 32 steps to a dispatch (CUDA graphs). ``--device``
times the train step alone on batches already on the card.

Reference baseline: the optimized Graph Transformer trains one epoch of
120,436 RetailRocket sessions in about 27 min on an NVIDIA L4 = 74.3
sessions/s; ``vs_baseline`` = ours / 74.3.

Timing: the slope over epochs. A warm-up window of 1 + N epochs (every CUDA
graph of the timed windows is captured there), then 1 epoch and 1 + N
epochs, each fenced once at each end by a synchronising readback; an epoch
takes (t_long - t_short) / N. Prints one JSON line on stdout (metric names
``torch_`` + the JAX bench's), the detail and the nvidia-smi line on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gat_recommendation_torch.data.batching import (
    SessionDataset,
    chain_iterator,
    collate,
    iterate_batches,
    make_grad_index,
    prefetch_to_device,
    stack_batches,
    stack_grad_indices,
    to_device,
)
from gat_recommendation_torch.data.graph import build_co_event_graph
from gat_recommendation_torch.device import nvidia_smi, resolve_device
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.ops.lazy_adamw import TAIL_TERMS
from gat_recommendation_torch.ops.rounding import mix_seed
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import (
    make_chained_sparse_train_step,
    make_sparse_train_step,
    next_steps_block,
)

BASELINE_SESSIONS_PER_SEC = 120_436 / (27 * 60)  # reference: 27 min/epoch on an NVIDIA L4
NUM_ITEMS = 466_865  # reference catalog size
BATCH_SIZE = 512
SUBCHAIN = 8  # a partial group runs as chains of this many steps, then single steps


def corpus_columns(num_sessions: int, num_items: int = NUM_ITEMS, seed: int = 0):
    """A RetailRocket-shaped session corpus as (session_id, timestamp,
    itemid) columns: geometric session lengths (3 .. 50 events, mean about
    6), Zipf item popularity over a permuted catalog. The same numpy streams
    as the JAX package's bench, so the same sessions."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.geometric(0.25, num_sessions) + 2, 3, 50)
    total = int(lengths.sum())
    ranks = np.arange(1, num_items, dtype=np.float64)
    probs = ranks**-1.2
    cum = np.cumsum(probs / probs.sum())
    perm = rng.permutation(num_items - 1)
    items = perm[np.minimum(np.searchsorted(cum, rng.random(total)), num_items - 2)] + 1
    return np.repeat(np.arange(num_sessions), lengths), np.arange(total, dtype=np.int64), items


def make_corpus(num_sessions: int, num_items: int = NUM_ITEMS, seed: int = 0):
    """The ``corpus_columns`` sessions, every event a view, and their
    co-occurrence graph from ``build_co_event_graph`` (window 5), so that
    assembly meets realistic CSR degrees. Returns the dataset and the
    graph's stats."""
    sid, ts, items = corpus_columns(num_sessions, num_items, seed)
    edges, stats = build_co_event_graph((sid, ts, items, "view"))
    ds = SessionDataset((sid, ts, items), (edges["item_i"], edges["item_j"]), num_negatives=5, num_items=num_items)
    return ds, stats


def make_training(num_items: int = NUM_ITEMS, bf16_moments=None, lazy: bool = False, device=None):
    """The optimized Graph Transformer at 256/256 (zero positional
    encodings), ``FusedEmbeddingAdamW(1e-3, weight_decay=1e-5)``, the dual
    loss; returns (model, optimizer, state, sparse step, chained sparse step)."""
    device = resolve_device(device)
    model = create_model("graph_transformer_optimized", num_items, embedding_dim=256, hidden_dim=256,
                         device=device, generator=torch.Generator(device).manual_seed(0))
    with torch.no_grad():
        model.cached_pe.zero_()
    moment_dtype = {None: None, "both": torch.bfloat16, "mu": (torch.bfloat16, None),
                    "nu": (None, torch.bfloat16)}[bf16_moments]
    optimizer = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, moment_dtype=moment_dtype, lazy=lazy)
    state = optimizer.init(model)
    loss_fn = create_loss_function("dual")
    return (model, optimizer, state, make_sparse_train_step(model, loss_fn, optimizer, state),
            make_chained_sparse_train_step(model, loss_fn, optimizer, state))


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def touched_rows(ds: SessionDataset, chain: int, epochs: int = 2, workers: int = 0) -> dict:
    """What the lazy optimizer meets on this corpus, from the host batches
    of the first `epochs` timed epochs: the unique rows a step touches (real
    and its bucket U; a chained group pads to its largest U) and the
    catch-up terms the gather computes for them (steps a row missed,
    at most the tail's TAIL_TERMS)."""
    last = np.zeros(ds.num_items, np.int64)
    unique, buckets, terms = [], [], []
    step = 0
    for e in range(epochs):
        for group in chain_iterator(iterate_batches(ds, BATCH_SIZE, shuffle=True, seed=e, engine="native",
                                                    workers=workers), chain):
            gidxs = [make_grad_index(b) for b in group]
            padded = max(len(g.uid) for g in gidxs) if len(group) == chain > 1 else None
            for g in gidxs:
                step += 1
                uid = np.unique(g.ids)
                uid = uid[uid != 0]
                unique.append(len(uid))
                buckets.append(padded or len(g.uid))
                terms.append(np.minimum(step - 1 - last[uid], TAIL_TERMS))
                last[uid] = step
    terms = np.concatenate(terms)
    return {"steps": step, "unique_rows_mean": float(np.mean(unique)), "unique_rows_max": int(np.max(unique)),
            "u_bucket_counts": {int(u): int(n) for u, n in zip(*np.unique(buckets, return_counts=True))},
            "catch_up_terms_mean": float(terms.mean()),
            "catch_up_terms_at_tail": float(np.mean(terms == TAIL_TERMS))}


def device_busy(run) -> dict:
    """One call of `run` (an epoch) under torch.profiler: the card's busy
    seconds (its operations' own time; user annotations, which span kernels
    counted already and the gaps between them, left out) and the traced
    call's wall seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e6 if rows else None
    return {"device_busy_s": busy, "traced_epoch_s": wall}


def main_e2e(num_sessions: int, workers: int, epochs_long: int, chain: int = 1, bf16_moments=None,
             lazy: bool = False, transfer_workers: int = 2, *, num_items: int = NUM_ITEMS, device=None,
             profile: bool = False) -> dict:
    """Sessions/s over whole epochs of the host pipeline and the train step.
    `profile` adds one traced epoch after the timed windows (the device's
    idle share over an epoch) and the touched-row statistics."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    ds, stats = make_corpus(num_sessions, num_items)
    setup_s = time.perf_counter() - t0
    model, optimizer, state, step, chained_step = make_training(num_items, bf16_moments, lazy, device)

    def transfer(hb):
        return to_device((hb, make_grad_index(hb)), device)

    def stack_group(items):
        gidxs = stack_grad_indices([make_grad_index(b) for b in items])
        return ("chained", *to_device((stack_batches(items), gidxs), device))

    def transfer_group(items):
        if len(items) == chain:
            return [stack_group(items)]
        out, i = [], 0
        while len(items) - i >= SUBCHAIN and chain > SUBCHAIN:
            out.append(stack_group(items[i:i + SUBCHAIN]))
            i += SUBCHAIN
        out.extend(transfer(b) for b in items[i:])
        return out

    nsteps = 0

    def run_epochs(n_epochs: int, seed0: int) -> float:
        nonlocal nsteps
        _fence(device)
        t0 = time.perf_counter()
        loss = None
        for e in range(n_epochs):
            raw = iterate_batches(ds, BATCH_SIZE, shuffle=True, seed=seed0 + e, engine="native", workers=workers)
            if chain > 1:
                for entries in prefetch_to_device(chain_iterator(raw, chain), size=4, transfer=transfer_group,
                                                  transfer_workers=transfer_workers, device=device):
                    for entry in entries:
                        if isinstance(entry[0], str):  # ("chained", batches, gidxs)
                            _, sb, sg = entry
                            seeds = [mix_seed(0, 0, nsteps + i) for i in range(sg.uid.shape[0])]
                            loss = chained_step(sb, sg, next_steps_block(model, optimizer, state, seeds, device))[-1]
                            nsteps += len(seeds)
                        else:
                            loss = step(entry, mix_seed(0, 0, nsteps))
                            nsteps += 1
            else:
                for db in prefetch_to_device(raw, size=4, transfer=transfer, transfer_workers=transfer_workers,
                                             device=device):
                    loss = step(db, mix_seed(0, 0, nsteps))
                    nsteps += 1
        _ = float(loss)  # the one fence: every step of the window has run
        return time.perf_counter() - t0

    # The warm-up runs the timed windows' seeds, so every (bucket, U) graph
    # they replay is captured before the clock runs.
    t_warm = run_epochs(1 + epochs_long, seed0=0)
    steps_before = nsteps
    t_short = run_epochs(1, seed0=0)
    steps_per_epoch = nsteps - steps_before
    t_long = run_epochs(1 + epochs_long, seed0=0)
    per_epoch = (t_long - t_short) / epochs_long
    sessions_per_sec = len(ds) / per_epoch
    detail = {
        "sessions": len(ds),
        "graph_edges": int(stats["num_edges"]),
        "epoch_s": per_epoch,
        "steps_per_epoch": steps_per_epoch,
        "ms_per_step": 1e3 * per_epoch / steps_per_epoch,
        "t_warm": t_warm,
        "t_short": t_short,
        "t_long": t_long,
        "engine": "native",
        "workers": workers,
        "chain": chain,
        "lazy": lazy,
        "transfer_workers": transfer_workers,
        "corpus_setup_s": setup_s,
        "device": _device_name(device),
    }
    if profile:
        traced = device_busy(lambda: run_epochs(1, seed0=0))
        busy = traced["device_busy_s"]
        detail["traced_epoch_s"] = traced["traced_epoch_s"]
        detail["device_busy_s"] = "not measured" if busy is None else busy
        # Against the unprofiled epoch: the trace's own cost is on the host.
        detail["device_idle_share"] = "not measured" if busy is None else 1.0 - busy / per_epoch
        if lazy:
            detail["touched_rows"] = touched_rows(ds, chain, workers=workers)
    return {
        "metric": "torch_train_sessions_per_sec_per_chip_e2e"
        + (f"_bf16mom_{bf16_moments}" if bf16_moments else "")
        + ("" if lazy else "_eager"),
        "value": sessions_per_sec,
        "unit": "sessions/s",
        "vs_baseline": sessions_per_sec / BASELINE_SESSIONS_PER_SEC,
        "device": detail["device"],
        "_detail": detail,
    }


def make_batches(num_items: int, batch_size: int, num_batches: int, seed: int = 0) -> list:
    """Synthetic bucketed host batches with a RetailRocket-like mix of
    session sizes (device-only mode)."""
    rng = np.random.default_rng(seed)
    bucket_probs = {8: 0.70, 16: 0.20, 32: 0.08, 56: 0.02}
    buckets = rng.choice(list(bucket_probs), size=num_batches, p=list(bucket_probs.values()))
    batches = []
    for b in range(num_batches):
        bucket_n = int(buckets[b])
        samples = []
        for _ in range(batch_size):
            n = int(np.clip(rng.geometric(0.25) + 1, 2, bucket_n))
            nodes = np.sort(rng.choice(np.arange(1, num_items), size=n, replace=False)).astype(np.int32)
            m = int(rng.integers(n, 6 * n))  # average degree about 18 in the real graph
            samples.append({
                "nodes": nodes,
                "edge_src": rng.integers(0, n, m).astype(np.int32),
                "edge_dst": rng.integers(0, n, m).astype(np.int32),
                "target": int(rng.integers(1, num_items)),
                "negatives": rng.integers(1, num_items, 5).astype(np.int32),
            })
        batches.append(collate(samples, bucket_n, 5))
    return batches


def main_device(lazy: bool = False, *, num_items: int = NUM_ITEMS, device=None, steps: tuple = (20, 320),
                num_batches: int = 12) -> dict:
    """The train step's rate on batches already on the device, no host
    pipeline: the slope between `steps` (short, long) step runs, twice."""
    device = resolve_device(device)
    model, optimizer, state, step, _chained = make_training(num_items, lazy=lazy, device=device)
    dev_batches = [to_device((hb, make_grad_index(hb)), device)
                   for hb in make_batches(num_items, BATCH_SIZE, num_batches)]
    loss = None
    for db in dev_batches:  # warm-up: every bucket shape once, then fence
        loss = step(db, 0)
    _ = float(loss)

    def run(nsteps: int) -> float:
        t0 = time.perf_counter()
        loss = None
        for n in range(nsteps):
            loss = step(dev_batches[n % len(dev_batches)], mix_seed(0, 0, n))
        _ = float(loss)  # the fence
        return time.perf_counter() - t0

    short, long = steps
    deltas = []
    for _ in range(2):
        t_short = run(short)
        t_long = run(long)
        deltas.append((t_long - t_short) / (long - short))
    per_step = sum(deltas) / len(deltas)
    sessions_per_sec = BATCH_SIZE / per_step
    return {
        "metric": "torch_train_sessions_per_sec_per_chip" + ("" if lazy else "_eager"),
        "value": sessions_per_sec,
        "unit": "sessions/s",
        "vs_baseline": sessions_per_sec / BASELINE_SESSIONS_PER_SEC,
        "device": _device_name(device),
        "_detail": {"ms_per_step": 1e3 * per_step, "lazy": lazy},
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", action="store_true", help="device-only step rate")
    p.add_argument("--sessions", type=int, default=120_436)
    p.add_argument("--workers", type=int, default=3, help="batch assembly threads (0: on the prefetch thread)")
    p.add_argument("--epochs", type=int, default=6, help="slope window (e2e)")
    p.add_argument("--chain", type=int, default=32, help="optimizer steps per dispatch (1 = unchained)")
    p.add_argument("--bf16-moments", nargs="?", const="both", default=None, choices=["both", "mu", "nu"],
                   help="bf16 moment storage with stochastic rounding; a value narrows one buffer")
    p.add_argument("--mesh", default=None, help="DATAxMODEL: not ported (ROADMAP.md, queue A8)")
    p.add_argument("--lazy", action=argparse.BooleanOptionalAction, default=True,
                   help="lazy catch-up AdamW (the default); --no-lazy the eager sparse AdamW sweep")
    p.add_argument("--transfer-workers", type=int, default=3, help="host-to-device transfer threads")
    p.add_argument("--profile", action="store_true",
                   help="one more traced epoch: the device's idle share, and the touched rows")
    args = p.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh: multi-GPU training is not ported yet (ROADMAP.md, queue A8)")
    result = (
        main_device(args.lazy)
        if args.device
        else main_e2e(args.sessions, args.workers, args.epochs, args.chain, args.bf16_moments, args.lazy,
                      args.transfer_workers, profile=args.profile)
    )
    emit(result)


def emit(result: dict) -> None:
    """The result's JSON line on stdout; its detail and the card's
    nvidia-smi line on stderr."""
    detail = result.pop("_detail")
    print(f"[bench detail] {json.dumps(detail)}", file=sys.stderr)
    print(f"[bench detail] {nvidia_smi()}", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
