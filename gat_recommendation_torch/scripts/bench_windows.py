"""Runs the end-to-end bench many times in turns and shows where each timed
window's host seconds went, to find windows that stall.

    python3 -m gat_recommendation_torch.scripts.bench_windows [--rounds 10] [--chain 32] \
        [--sessions 30000] [--out outputs/bench_windows.jsonl] [--device cpu]

Each round runs ``bench.main_e2e`` (lazy, 3 batch and 3 transfer threads) on
a 1x1 mesh and without one, in turns (mesh, plain, plain, mesh, ...), and
prints one JSON line a run: sessions/s, the short and long windows' seconds,
and each window's host account (``bench.HostAccount``: seconds waiting for
the prefetch thread, dispatching chained entries and single steps, in the
fence and in garbage collections; the longest wait or call; each epoch's
host seconds; graphs captured inside the window). A run stalls where a timed
epoch's host seconds exceed twice the median of the run's timed epochs. The
last lines count the runs that stalled and those whose slope was not
positive, and give the card's name and power limit. `--out` keeps every
run's whole detail. On the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import torch

from gat_recommendation_torch import bench
from gat_recommendation_torch.device import nvidia_smi, resolve_device
from gat_recommendation_torch.parallel import distributed


def stalled_epochs(detail: dict) -> list[float]:
    """The timed epochs (short and long windows) whose host seconds exceed
    twice the median of the run's timed epochs."""
    epochs = detail["host"]["short"]["epoch_host_s"] + detail["host"]["long"]["epoch_host_s"]
    median = statistics.median(epochs)
    return [s for s in epochs if s > 2 * median]


def run(rounds: int, chain: int, sessions: int, epochs: int, num_items: int, device, out: Path | None) -> dict:
    stalls, negative, lines = 0, 0, []
    for i in range(2 * rounds):
        mesh_shape = (1, 1) if i % 4 in (0, 3) else None
        result = bench.main_e2e(sessions, 3, epochs, chain, lazy=True, transfer_workers=3, num_items=num_items,
                                device=device, mesh_shape=mesh_shape)
        detail = result["_detail"]
        stalled = stalled_epochs(detail)
        stalls += bool(stalled)
        negative += not result["value"] > 0
        line = {"run": i, "mesh": detail["mesh"], "value": result["value"], "t_short": detail["t_short"],
                "t_long": detail["t_long"], "stalled_epochs_s": stalled,
                "host": {w: detail["host"][w] for w in ("short", "long")}}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if out is not None:
            with out.open("a") as f:
                f.write(json.dumps(result) + "\n")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"runs": len(lines), "stalled": stalls, "not_positive": negative, "lines": lines}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rounds", type=int, default=10, help="pairs of runs (mesh and plain)")
    p.add_argument("--chain", type=int, default=32)
    p.add_argument("--sessions", type=int, default=30_000)
    p.add_argument("--epochs", type=int, default=2, help="the bench's slope window")
    p.add_argument("--num-items", type=int, default=bench.NUM_ITEMS)
    p.add_argument("--out", type=Path, default=None, help="a JSONL file for every run's whole result")
    p.add_argument("--device", default=None, help="cpu to run on the host (tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
    try:
        summary = run(args.rounds, args.chain, args.sessions, args.epochs, args.num_items, device, args.out)
    finally:
        distributed.shutdown()
    print(json.dumps({k: v for k, v in summary.items() if k != "lines"}))
    if device.type == "cuda":
        print(nvidia_smi())
    return summary


if __name__ == "__main__":
    main()
