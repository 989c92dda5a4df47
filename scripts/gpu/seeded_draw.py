#!/usr/bin/env python3
"""Time the seeded draw of the main path's model on one NVIDIA GPU, for whichever port is importable.

    python3 scripts/gpu/seeded_draw.py [--reps 3]
    (cd <other checkout> && python3 <this script>)

From the root of the checkout it is run from, builds the bench's model (the
optimized Graph Transformer over 466,865 items at 256/256, seed 0 by
default) on the card, ``--reps`` times, and times each build; then
``Trainer(model, seed=42).init_state()`` over it, ``--reps`` times (each one
draws the parameters anew from the Trainer's seed). Also times the draw's
parts on the host: 119.5 M uniform numbers from a CPU generator into one
[466,944, 256] float32 host tensor, and its copy to the card from pageable
and from pinned memory. Every time is taken between two
``torch.cuda.synchronize()``. Prints one JSON line (with the host's CPU and
torch thread counts) and the nvidia-smi line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# The port of the checkout this runs from: the current directory first.
sys.path.insert(0, str(Path.cwd()))

NUM_ITEMS, ROWS, DIM = 466_865, 466_944, 256


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("seeded_draw: no CUDA device", file=sys.stderr)
        return 1
    from gat_recommendation_torch.models.registry import create_model
    from gat_recommendation_torch.train.trainer import Trainer

    torch.zeros(1, device="cuda")  # the context, outside the first timing
    out = {"checkout": str(Path.cwd()), "host_cpus": os.cpu_count(), "torch_threads": torch.get_num_threads(),
           "torch": torch.__version__, "create_model_s": [], "init_state_s": []}
    model = None
    for _ in range(args.reps):
        del model
        torch.cuda.empty_cache()
        model, seconds = timed(lambda: create_model("graph_transformer_optimized", NUM_ITEMS, embedding_dim=DIM,
                                                    hidden_dim=DIM))
        out["create_model_s"].append(seconds)
    with tempfile.TemporaryDirectory() as tmp:  # the Trainer writes nothing before train()
        trainer = Trainer(model, lambda epoch: iter(()), lambda: iter(()), output_dir=tmp, seed=42)
        for _ in range(args.reps):
            out["init_state_s"].append(timed(trainer.init_state)[1])
    del trainer, model
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(0)
    host, out["host_draw_s"] = timed(lambda: torch.empty(ROWS, DIM).uniform_(-0.1, 0.1, generator=gen))
    card = torch.empty(ROWS, DIM, device="cuda")
    out["copy_pageable_s"] = timed(lambda: card.copy_(host))[1]
    pinned = host.pin_memory()
    out["copy_pinned_s"] = timed(lambda: card.copy_(pinned))[1]
    print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
