"""Times the optimized Graph Transformer's eval forward with kernel 1 against
the same forward with the plain attention.

    python3 -m gat_recommendation_torch.scripts.bench_attention [--buckets 8,16,32,56] [--steps 200]

The port of the repo's ``scripts/bench_attention.py``. The model at full
width (466,865 items, D = 256, 2 layers, 2 heads of 128), weights drawn from
seed 0 and zero Laplacian encodings, runs its eval forward at B = 512 for each
node bucket on a batch made as the JAX script makes it (random sessions of 2
to N nodes and n to 6n random edges), copied to the card as training batches
are: with the bit-packed adjacency, which kernel 1 reads as it is. The
second row of a bucket swaps ``session_attention_reference`` into the
Graph Transformer's conv (a patch of this tool, as the JAX script's
``mock.patch``; the port itself has no switch for it), which unpacks the
adjacency first. Each step feeds its output back into the next step's node
embeddings, so the steps form a chain that cannot overlap; a forward's time
is the slope between a run of 20 steps and one of 20 + ``--steps``, each
timed with CUDA events. Prints a markdown table and the card's name and power
limit, and returns the rows. Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
from unittest import mock

import numpy as np
import torch

from gat_recommendation_torch.data.batching import collate, to_device
from gat_recommendation_torch.device import nvidia_smi
from gat_recommendation_torch.models import layers
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.ops.session_attention import session_attention, session_attention_reference

DIM = 256


def make_batch(bucket_n: int, batch_size: int, num_items: int, device, seed: int = 0):
    """The JAX script's batch of `batch_size` random sessions in bucket
    `bucket_n`, on `device`."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(batch_size):
        n = int(np.clip(rng.geometric(0.25) + 1, 2, bucket_n))
        nodes = np.sort(rng.choice(np.arange(1, num_items), size=n, replace=False)).astype(np.int32)
        m = int(rng.integers(n, 6 * n))
        samples.append({
            "nodes": nodes,
            "edge_src": rng.integers(0, n, m).astype(np.int32),
            "edge_dst": rng.integers(0, n, m).astype(np.int32),
            "target": int(rng.integers(1, num_items)),
            "negatives": rng.integers(1, num_items, 5).astype(np.int32),
        })
    return to_device(collate(samples, bucket_n, 5), device)


def slope_ms(step, x: torch.Tensor, steps: int) -> float:
    """ms a step of the chain x <- step(x): (t(20 + steps) - t(20)) / steps,
    each from CUDA events around the run, after 30 steps of warm-up."""
    def run(n: int, x: torch.Tensor):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            x = step(x)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), x

    _, x = run(30, x)
    t_short, x = run(20, x)
    t_long, x = run(20 + steps, x)
    return (t_long - t_short) / steps


def main(argv: list[str] | None = None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--buckets", type=str, default="8,16,32,56")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--num-items", type=int, default=466_865)
    p.add_argument("--steps", type=int, default=200)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_attention times kernel 1 on the card")
    dev = torch.device("cuda")

    model = create_model("graph_transformer_optimized", num_items=args.num_items, embedding_dim=DIM,
                         hidden_dim=DIM, device=dev, generator=torch.Generator().manual_seed(0))
    model.eval()
    rows = []
    print("| bucket N | plain forward | kernel forward | speedup |", flush=True)
    print("|---|---|---|---|", flush=True)
    for bucket in [int(b) for b in args.buckets.split(",")]:
        batch = make_batch(bucket, args.batch_size, args.num_items, dev)

        @torch.no_grad()
        def step(x: torch.Tensor) -> torch.Tensor:
            # feed the output back: consecutive forwards form a dependency chain
            return x + 1e-30 * model(batch, node_embeddings=x)[:, None, :]

        x0 = torch.from_numpy(np.random.default_rng(1).normal(size=(args.batch_size, bucket, DIM))
                              .astype(np.float32)).to(dev)
        times = {}
        for name, attention in (("plain", session_attention_reference), ("kernel", session_attention)):
            with mock.patch.object(layers, "session_attention", attention):
                times[name] = slope_ms(step, x0, args.steps)
        rows.append({"bucket": bucket, "batch": args.batch_size, "plain_ms": times["plain"],
                     "kernel_ms": times["kernel"], "speedup": times["plain"] / times["kernel"],
                     "adj_packed": batch.adj_packed})
        print(f"| {bucket} | {times['plain']:.3f} ms | {times['kernel']:.3f} ms "
              f"| {times['plain'] / times['kernel']:.2f}x |", flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"bench_attention": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
