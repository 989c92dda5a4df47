"""Smoke-train every model of the registry on synthetic batches.

    python3 -m gat_recommendation_torch.smoke_test_all_models            # on the card
    python3 -m gat_recommendation_torch.smoke_test_all_models --device cpu

The port of the JAX package's ``scripts/smoke_test_all_models.py``: the same
four synthetic batches of 8 sessions (3 .. 7 items, random edges, 5
negatives) from ``np.random.default_rng(0)``, widths 32, ``laplacian_k=4``
for the Graph Transformers with their encodings from the same 59-edge path
graph, 2 epochs of the dense train step (``make_train_step``, the dual loss,
``FusedEmbeddingAdamW(1e-3, weight_decay=1e-4)``: ``optax.adamw``'s
defaults, which the JAX script uses), seeds ``epoch * 100 + batch``. A model
passes when every loss is finite. Prints a pass/fail table and exits 1 if
any model failed.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch

from gat_recommendation_torch.data.batching import SessionBatch, collate, to_device
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.models.registry import MODEL_NAMES, create_model
from gat_recommendation_torch.train.losses import dual_loss
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import make_train_step

NUM_ITEMS = 500
EPOCHS = 2
# The co-occurrence graph the positional encodings come from: a path over ids 1 .. 60.
PE_EDGES = (np.arange(1, 60, dtype=np.int64), np.arange(2, 61, dtype=np.int64))


def make_synthetic_batches(num_batches: int = 4, batch_size: int = 8, seed: int = 0) -> list[SessionBatch]:
    """Host batches of the 8-node bucket, drawn as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(num_batches):
        samples = []
        for _ in range(batch_size):
            n = int(rng.integers(3, 8))
            nodes = np.sort(rng.choice(np.arange(1, NUM_ITEMS), n, replace=False)).astype(np.int32)
            m = int(rng.integers(n, 3 * n))
            samples.append({
                "nodes": nodes,
                "edge_src": rng.integers(0, n, m).astype(np.int32),
                "edge_dst": rng.integers(0, n, m).astype(np.int32),
                "target": int(rng.integers(1, NUM_ITEMS)),
                "negatives": rng.integers(1, NUM_ITEMS, 5).astype(np.int32),
            })
        batches.append(collate(samples, 8, 5))
    return batches


def smoke_test(name: str, batches: list[SessionBatch], device: torch.device) -> dict:
    """Two epochs of dense steps of model `name` on `device`: the losses, all
    read back at the end, and the wall seconds of the steps."""
    kwargs: dict = dict(embedding_dim=32, hidden_dim=32)
    if name.startswith("graph_transformer"):
        kwargs["laplacian_k"] = 4
    model = create_model(name, NUM_ITEMS, device=device, **kwargs)
    model.precompute_pe(*PE_EDGES)
    optimizer = FusedEmbeddingAdamW(1e-3, weight_decay=1e-4)
    step = make_train_step(model, dual_loss, optimizer, optimizer.init(model))
    on_device = [to_device(b, device) for b in batches]

    t0 = time.perf_counter()
    losses = [step(b, seed=epoch * 100 + i) for epoch in range(EPOCHS) for i, b in enumerate(on_device)]
    losses = torch.stack(losses).cpu().numpy()
    elapsed = time.perf_counter() - t0
    return {"pass": bool(np.all(np.isfinite(losses))), "first_loss": float(losses[0]),
            "last_loss": float(losses[-1]), "seconds": elapsed}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(parser.parse_args(argv).device)
    batches = make_synthetic_batches()
    results = {}
    for name in MODEL_NAMES:
        try:
            results[name] = smoke_test(name, batches, device)
        except Exception as e:  # one model's failure is a FAIL row; the others still run
            traceback.print_exc()
            results[name] = {"pass": False, "error": f"{type(e).__name__}: {e}"}

    print(f"{'model':32s} {'status':8s} {'first':>8s} {'last':>8s} {'time':>6s}")
    failed = False
    for name, r in results.items():
        if r["pass"]:
            print(f"{name:32s} {'PASS':8s} {r['first_loss']:8.4f} {r['last_loss']:8.4f} {r['seconds']:5.1f}s")
        else:
            failed = True
            print(f"{name:32s} {'FAIL':8s} {r.get('error', 'NaN loss')}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
