"""Times the full-catalog top-k selectors at the evaluation configuration.

    python3 -m gat_recommendation_torch.scripts.bench_scoring [--steps 100] [--k 20] [--device cpu]

The selectors of ``ops/scoring.py`` at B = 512 sessions over the padded
466,944-row table (466,865 items), D = 256, k = 20: the dense oracle (one
matmul, one stable sort), the exact two-level selector at chunk 32 (kernel 2
on the card) and at chunks 8, 16 and 64 (plain PyTorch), the two-level
selector without the phantom mask, the approximate selector, and the bare
matmul with a row max (the floor every selector pays). Each step's input is
perturbed by the previous step's top score, so no step can start before the
one before it has ended; a variant's time is the slope between a short and a
long run (ms a step), each ended by a synchronise. Prints one line a variant,
the card's name and power limit, and one JSON line of the times. On the card
unless ``--device cpu``. The port of the repo's ``scripts/bench_scoring.py``.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from gat_recommendation_torch.device import nvidia_smi, resolve_device
from gat_recommendation_torch.models.base import padded_rows
from gat_recommendation_torch.ops import scoring
from gat_recommendation_torch.utils.roofline import H100_SXM

DIM = 256


def _matmul_only(se, emb, k, num_items):
    s = se @ emb.T
    return s.amax(dim=-1, keepdim=True), None  # forces the whole product


def variants() -> dict:
    out = {
        "matmul_only": _matmul_only,
        "dense": scoring.dense_topk,
        "two_level": scoring.two_level_topk,
        "two_level_nomask": lambda se, emb, k, num_items: scoring.two_level_topk(se, emb, k, None),
        "approx": scoring.approx_topk,
    }
    for chunk in (8, 16, 64):
        out[f"two_level_c{chunk}"] = functools.partial(scoring.two_level_topk, chunk=chunk)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(batch_size: int = 512, num_items: int = 466_865, k: int = 20, steps: int = 100, device=None) -> dict:
    """ms a step of every variant on `device`, and where they ran."""
    device = resolve_device(device)
    V = padded_rows(num_items)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.normal(size=(V, DIM)).astype(np.float32)).to(device)
    se0 = torch.from_numpy(rng.normal(size=(batch_size, DIM)).astype(np.float32)).to(device)
    results = {}
    with torch.inference_mode():
        for name, fn in variants().items():
            def step(se, fn=fn):
                s, _ = fn(se, emb, k, num_items)
                return se * (1.0 + 1e-30 * s[:, :1])  # the next step depends on this one

            def window(n, se):
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(n):
                    se = step(se)
                _sync(device)
                return time.perf_counter() - t0, se

            se = step(se0)  # warm-up: kernels built, allocator warm
            t_short, se = window(max(steps // 5, 1), se)
            t_long, se = window(max(steps // 5, 1) + steps, se)
            results[name] = (t_long - t_short) / steps * 1e3
            print(f"{name:20s} {results[name]:9.4f} ms", flush=True)
    floor = results["matmul_only"] + batch_size * V * 4 / (H100_SXM.hbm_gb_per_s * 1e9) * 1e3
    card = nvidia_smi() if device.type == "cuda" else None
    if card is not None:
        print(f"exact floor estimate (the matmul and one read of the scores at the H100's "
              f"{H100_SXM.hbm_gb_per_s:.0f} GB/s): {floor:.4f} ms")
        print(card)
    return {"device": str(device), "card": card, "batch_size": batch_size, "rows": V, "num_items": num_items,
            "dim": DIM, "k": k, "steps": steps, "ms": results}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--num-items", type=int, default=466_865)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    out = run(args.batch_size, args.num_items, args.k, args.steps, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
