#!/usr/bin/env python3
"""Tracked experiment runs: a short training run of each registered model.

    python3 -m gat_recommendation_torch.scripts.pipeline.mlflow_experiment [--models gat graphsage] [--device cpu]

The port of ``scripts/pipeline/mlflow_experiment.py``: the same flags and
defaults, plus ``--device`` (``cuda`` unless told otherwise). Each model
trains for ``--epochs`` epochs over four synthetic batches of 16 sessions
(``smoke_test_all_models.make_synthetic_batches``: the JAX script's draws
from ``default_rng(0)``), widths 32, ``laplacian_k=4`` for the Graph
Transformers with their encodings from the same 59-edge path graph, the
dense train step with the dual loss and ``FusedEmbeddingAdamW(lr,
weight_decay=1e-4)`` (``optax.adamw``'s defaults, which the JAX script
uses; kernel 4 updates the table), seeds ``epoch * 100 + batch``. The run's
params (model, lr, epochs, the parameter count, the registry's description)
and each epoch's mean train loss go to MLflow where it is installed, else
to a JSON store under ``--tracking-dir`` (``<experiment>/<model>-<id>/run.json``).
"""

from __future__ import annotations

import argparse
import json
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.data.batching import to_device
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.models.registry import count_params, create_model
from gat_recommendation_torch.smoke_test_all_models import NUM_ITEMS, PE_EDGES, make_synthetic_batches
from gat_recommendation_torch.train.losses import dual_loss
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import make_train_step
from gat_recommendation_torch.utils.logging import get_logger

MODEL_REGISTRY = {
    "graphsage": "GraphSAGE baseline (mean aggregator)",
    "gat": "Graph Attention Network baseline",
    "graph_transformer": "Graph Transformer with Laplacian PE (FFN)",
    "graph_transformer_optimized": "Optimized Graph Transformer (no FFN, 2 layers, 2 heads)",
}


class LocalTracker:
    """JSON-file MLflow stand-in: one run directory per (experiment, run)."""

    def __init__(self, tracking_dir: str, experiment: str):
        self.root = Path(tracking_dir) / experiment
        self.root.mkdir(parents=True, exist_ok=True)
        self.run_dir: Path | None = None
        self.data: dict = {}

    def start_run(self, run_name: str):
        self.run_dir = self.root / f"{run_name}-{uuid.uuid4().hex[:8]}"
        self.run_dir.mkdir(parents=True)
        self.data = {"run_name": run_name, "params": {}, "metrics": {}, "tags": {},
                     "start_time": time.time()}
        return self

    def log_params(self, params: dict):
        self.data["params"].update({k: str(v) for k, v in params.items()})

    def log_metrics(self, metrics: dict, step: int | None = None):
        for k, v in metrics.items():
            self.data["metrics"].setdefault(k, []).append(
                {"value": float(v), "step": step, "time": time.time()}
            )

    def set_tags(self, tags: dict):
        self.data["tags"].update(tags)

    def end_run(self):
        self.data["end_time"] = time.time()
        with open(self.run_dir / "run.json", "w") as f:
            json.dump(self.data, f, indent=2)
        get_logger(__name__).info(f"Run logged to {self.run_dir}")


def get_tracker(tracking_dir: str, experiment: str):
    try:
        import mlflow

        mlflow.set_tracking_uri(tracking_dir)
        mlflow.set_experiment(experiment)
        return "mlflow", mlflow
    except ImportError:
        get_logger(__name__).info("mlflow not installed; using local JSON tracking store")
        return "local", LocalTracker(tracking_dir, experiment)


def run_experiment(model_name: str, tracker_kind: str, tracker, args) -> dict:
    """One tracked run of `model_name` on ``args.device``: the last step's
    loss and whether every loss was finite (read back once an epoch)."""
    device = resolve_device(args.device)
    batches = [to_device(b, device) for b in make_synthetic_batches(4, 16)]

    kwargs: dict = dict(embedding_dim=32, hidden_dim=32)
    if model_name.startswith("graph_transformer"):
        kwargs["laplacian_k"] = 4
    model = create_model(model_name, NUM_ITEMS, device=device, **kwargs)
    model.precompute_pe(*PE_EDGES)
    optimizer = FusedEmbeddingAdamW(args.lr, weight_decay=1e-4)
    step = make_train_step(model, dual_loss, optimizer, optimizer.init(model))

    run_params = {"model": model_name, "lr": args.lr, "epochs": args.epochs,
                  "num_params": count_params(model),
                  "description": MODEL_REGISTRY[model_name]}

    if tracker_kind == "mlflow":
        ctx = tracker.start_run(run_name=model_name)
        tracker.log_params(run_params)
    else:
        tracker.start_run(model_name)
        tracker.log_params(run_params)

    losses: list[float] = []
    for epoch in range(args.epochs):
        epoch_losses = [step(b, seed=epoch * 100 + i) for i, b in enumerate(batches)]
        losses.extend(torch.stack(epoch_losses).cpu().tolist())
        tracker.log_metrics({"train_loss": float(np.mean(losses[-len(batches):]))}, step=epoch)

    if tracker_kind == "mlflow":
        ctx.__exit__(None, None, None)
    else:
        tracker.end_run()
    return {"final_loss": losses[-1], "finite": bool(np.isfinite(losses).all())}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Tracked experiment runs")
    parser.add_argument("--models", nargs="+", default=list(MODEL_REGISTRY),
                        choices=list(MODEL_REGISTRY))
    parser.add_argument("--tracking-dir", type=str, default="mlruns")
    parser.add_argument("--experiment", type=str, default="session-recommendation")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run every model asked for; returns each model's result."""
    args = parse_args(argv)
    logger = get_logger(__name__)
    kind, tracker = get_tracker(args.tracking_dir, args.experiment)
    results = {}
    for name in args.models:
        logger.info(f"Running {name}...")
        results[name] = run_experiment(name, kind, tracker, args)
        logger.info(f"{name}: final_loss={results[name]['final_loss']:.4f} finite={results[name]['finite']}")
    return results


if __name__ == "__main__":
    main()
