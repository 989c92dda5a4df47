"""Validate all four models on a subset of the train split.

    python3 -m gat_recommendation_torch.scripts.pipeline.run_full_pipeline [--num-sessions 100] ...

The port of ``scripts/pipeline/run_full_pipeline.py``: the first
``--num-sessions`` session ids of the train CSV in file order, each model of
the registry at widths 64 (``laplacian_k=8`` for the Graph Transformers,
their encodings from the full graph), ``--num-epochs`` epochs of the dense
train step with the listwise loss and ``FusedEmbeddingAdamW(1e-3,
weight_decay=1e-4)`` (``optax.adamw``'s defaults, which the JAX script
uses), step seeds ``epoch * 1000 + i``; then recall@10 over the subset. A
model passes when every loss is finite and the last is below 1.5 times the
first. Writes the results JSON; exits 1 if any model failed. ``--device`` as
in ``train_baseline``.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.data.batching import SessionDataset, iterate_batches, to_device
from gat_recommendation_torch.data.csv_io import read_csv
from gat_recommendation_torch.data.graph import load_edges
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.models.registry import MODEL_NAMES, create_model
from gat_recommendation_torch.train.losses import listwise_loss
from gat_recommendation_torch.train.metrics import compute_recall_at_k
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import make_eval_step, make_train_step
from gat_recommendation_torch.utils.io import save_json
from gat_recommendation_torch.utils.logging import get_logger
from gat_recommendation_torch.utils.seed import set_seed


def session_subset(path: str, num_sessions: int) -> dict:
    """The rows of the first `num_sessions` session ids of the CSV, in file order."""
    sessions = read_csv(path)
    sid = sessions["session_id"]
    _, first = np.unique(sid, return_index=True)
    keep = np.isin(sid, sid[np.sort(first)[:num_sessions]])
    return {k: v[keep] for k, v in sessions.items()}


def validate_model(name: str, ds: SessionDataset, edges, args, device: torch.device) -> dict:
    t0 = time.perf_counter()
    kwargs: dict = dict(embedding_dim=64, hidden_dim=64)
    if name.startswith("graph_transformer"):
        kwargs["laplacian_k"] = 8
    model = create_model(name, ds.num_items, device=device,
                         generator=torch.Generator().manual_seed(args.seed), **kwargs)
    model.precompute_pe(*edges)
    optimizer = FusedEmbeddingAdamW(1e-3, weight_decay=1e-4)
    step = make_train_step(model, listwise_loss, optimizer, optimizer.init(model))

    losses = []
    for epoch in range(args.num_epochs):
        for i, hb in enumerate(iterate_batches(ds, batch_size=args.batch_size, seed=epoch)):
            losses.append(step(to_device(hb, device), seed=epoch * 1000 + i))
    losses = torch.stack(losses).cpu().numpy().tolist()  # one readback

    eval_step = make_eval_step(model, 10)
    preds, targets = [], []
    for hb in iterate_batches(ds, batch_size=args.batch_size, shuffle=False):
        top = eval_step(to_device(hb, device)).cpu().numpy()
        m = np.asarray(hb.sample_mask)
        preds.append(top[m])
        targets.append(np.asarray(hb.targets)[m])
    recall10 = compute_recall_at_k(np.concatenate(preds), np.concatenate(targets), 10)
    ok = bool(np.all(np.isfinite(losses)) and losses[-1] < losses[0] * 1.5)
    return {"pass": ok, "first_loss": losses[0], "last_loss": losses[-1], "recall@10": recall10,
            "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Validate all models on a data subset")
    parser.add_argument("--train-sessions", type=str, default="data/processed/train.csv")
    parser.add_argument("--graph-edges", type=str, default="data/processed/graph_edges.csv")
    parser.add_argument("--num-sessions", type=int, default=100)
    parser.add_argument("--num-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--results-file", type=str, default="outputs/pipeline_validation.json")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    logger = get_logger(__name__)
    device = resolve_device(args.device)
    set_seed(args.seed)
    edges = load_edges(args.graph_edges)
    ds = SessionDataset(session_subset(args.train_sessions, args.num_sessions), edges)
    logger.info(f"Subset: {len(ds)} sessions, num_items={ds.num_items:,}")

    results: dict = {"num_sessions": len(ds), "models": {}}
    all_ok = True
    for name in MODEL_NAMES:  # graphsage, gat, graph_transformer, graph_transformer_optimized
        try:
            r = validate_model(name, ds, edges, args, device)
        except Exception as e:  # one model's failure is its row; the others still run
            traceback.print_exc()
            r = {"pass": False, "error": str(e)}
        results["models"][name] = r
        all_ok &= r["pass"]
        if "error" in r:
            logger.error(f"{name}: FAIL ({r['error']})")
        else:
            logger.info(f"{name}: loss {r['first_loss']:.4f}->{r['last_loss']:.4f}, recall@10={r['recall@10']:.4f} "
                        f"({r['seconds']:.1f}s) {'PASS' if r['pass'] else 'FAIL'}")

    results["pass"] = bool(all_ok)
    Path(args.results_file).parent.mkdir(parents=True, exist_ok=True)
    save_json(results, args.results_file)
    logger.info(f"Pipeline validation {'PASSED' if all_ok else 'FAILED'} -> {args.results_file}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
