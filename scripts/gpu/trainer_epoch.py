#!/usr/bin/env python3
"""Time ``Trainer.train_epoch`` on the bench corpus, on one NVIDIA GPU, for whichever port is importable.

    python3 scripts/gpu/trainer_epoch.py save --sessions 120436 --out build/corpus.npz
    python3 scripts/gpu/trainer_epoch.py time --corpus build/corpus.npz --chain 32 --workers 3 \\
        --transfer-workers 3
    (cd <other checkout> && python3 <this script> time --corpus ... --chain 32)

``save`` writes ``gat_recommendation_torch.bench.make_corpus``'s sessions and
graph edges as arrays, so that a checkout without the pandas-free graph
builder (an older commit of the port) trains on the same corpus. ``time``
trains, from the root of the checkout it is run from, the bench's model (the optimized Graph Transformer at 256/256 over
466,865 items, zero positional encodings, lazy float32 AdamW, the dual loss,
dropout 0.1) with that checkout's ``Trainer``, batches of 512 from the C++ engine, ``chain`` steps a dispatch:
one warm-up epoch (it captures the CUDA graphs), then ``--epochs`` epochs,
each ended by the Trainer's own readback of the mean loss. ``--workers`` and
``--transfer-workers`` go to ``iterate_batches`` and the ``Trainer`` where
that port takes them (a port without them assembles and transfers inline,
and the line says so). One traced epoch more gives the card's busy seconds
(torch.profiler) against the median epoch. ``--switch-interval`` sets the
interpreter's thread switch interval for the run (how long a thread that
wants the interpreter lock waits before it forces a switch). Prints one
JSON line and the nvidia-smi line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# The port of the checkout this runs from: the current directory first.
sys.path.insert(0, str(Path.cwd()))

NUM_ITEMS, BATCH = 466_865, 512


def save(sessions: int, out: Path) -> None:
    from gat_recommendation_torch.bench import corpus_columns
    from gat_recommendation_torch.data.graph import build_co_event_graph

    sid, ts, items = corpus_columns(sessions)
    edges, stats = build_co_event_graph((sid, ts, items, "view"))
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, sid=sid, ts=ts, items=items, item_i=edges["item_i"], item_j=edges["item_j"])
    print(json.dumps({"saved": str(out), "sessions": sessions, "events": len(items), "graph_edges": stats["num_edges"]}))


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def busy_seconds(run) -> float | str:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sum(e.self_device_time_total for e in rows) / 1e6 if rows else "not measured"


def time_epochs(corpus: Path, chain: int, workers: int, transfer_workers: int, epochs: int) -> dict:
    import gat_recommendation_torch
    from gat_recommendation_torch.data import batching
    from gat_recommendation_torch.data.batching import SessionDataset, iterate_batches
    from gat_recommendation_torch.models.registry import create_model
    from gat_recommendation_torch.train.losses import create_loss_function
    from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
    from gat_recommendation_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("trainer_epoch.py times the card; no CUDA device here")
    torch.backends.cuda.matmul.allow_tf32 = False
    # A port before the host pipeline has neither pooled assembly nor prefetch.
    pooled = prefetched = hasattr(batching, "prefetch_to_device")
    with np.load(corpus) as z:
        ds = SessionDataset((z["sid"], z["ts"], z["items"]), (z["item_i"], z["item_j"]), num_negatives=5,
                            num_items=NUM_ITEMS)
    batch_kw = {"workers": workers} if pooled else {}
    # No generator: seed 0 in every port (from a card generator before the
    # weights were drawn on the host, from a CPU one since).
    model = create_model("graph_transformer_optimized", NUM_ITEMS, embedding_dim=256, hidden_dim=256,
                         dropout=0.1)
    with torch.no_grad():
        model.cached_pe.zero_()
    trainer = Trainer(model, lambda e: iterate_batches(ds, BATCH, shuffle=True, seed=e, **batch_kw),
                      lambda: iter(()), optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True),
                      output_dir=corpus.parent / "trainer_epoch_unused", loss_fn=create_loss_function("dual"), seed=0,
                      sparse_embedding_grads=True, chain=chain,
                      **({"transfer_workers": transfer_workers} if prefetched else {}))
    trainer.init_state(reset_parameters=False)
    t0 = time.perf_counter()
    trainer.train_epoch()  # the warm-up: graph captures, kernel loads
    warm = time.perf_counter() - t0
    walls = []
    for e in range(1, 1 + epochs):
        trainer.current_epoch = e
        t0 = time.perf_counter()
        loss = trainer.train_epoch()  # ends in the epoch's one readback
        walls.append(time.perf_counter() - t0)
    epoch_s = statistics.median(walls)
    busy = busy_seconds(trainer.train_epoch)
    steps = trainer.opt_state["count"] // (epochs + 2)
    return {
        "package": str(Path(gat_recommendation_torch.__file__).parent),
        "chain": chain, "workers": workers if pooled else "inline (not in this port)",
        "transfer_workers": transfer_workers if prefetched else "inline (not in this port)",
        "sessions": len(ds), "steps_per_epoch": steps, "warm_epoch_s": warm, "epoch_s_runs": walls,
        "epoch_s": epoch_s, "sessions_per_s": len(ds) / epoch_s, "ms_per_step": 1e3 * epoch_s / steps,
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / epoch_s if isinstance(busy, float) else busy,
        "last_loss": loss, "device": torch.cuda.get_device_name(0),
        "switch_interval_s": sys.getswitchinterval(), "omp_threads": torch.get_num_threads(),
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="mode", required=True)
    s = sub.add_parser("save")
    s.add_argument("--sessions", type=int, default=120_436)
    s.add_argument("--out", type=Path, required=True)
    t = sub.add_parser("time")
    t.add_argument("--corpus", type=Path, required=True)
    t.add_argument("--chain", type=int, default=32)
    t.add_argument("--workers", type=int, default=3)
    t.add_argument("--transfer-workers", type=int, default=3)
    t.add_argument("--epochs", type=int, default=3)
    t.add_argument("--switch-interval", type=float, default=None,
                   help="sys.setswitchinterval for the run, in seconds (the interpreter's default: 0.005)")
    args = p.parse_args()
    if args.mode == "save":
        save(args.sessions, args.out)
        return
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    print(json.dumps(time_epochs(args.corpus, args.chain, args.workers, args.transfer_workers, args.epochs)))
    print(nvidia_smi())
    sys.stdout.flush()


if __name__ == "__main__":
    main()
