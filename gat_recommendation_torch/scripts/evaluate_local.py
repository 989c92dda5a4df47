"""Evaluate saved checkpoints on the test split (the Quickstart's evaluation step).

    python3 -m gat_recommendation_torch.scripts.evaluate_local [--outputs-dir outputs] [--which best] ...

The port of ``scripts/evaluate_local.py``: for every ``<outputs-dir>/<model>/
checkpoint_<which>`` it rebuilds the model from the checkpoint's
``meta.json`` (``train/checkpoint.py``), evaluates recall@k and NDCG@k on the
test split, logs a table and writes ``evaluation_results.json`` (a model
that fails is recorded with its error, not raised). Batches of one node
bucket go CHAIN at a time through the chained eval step (CUDA graphs on the
card); a partial group runs batch by batch. ``--device`` as in
``train_baseline``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.data.batching import (
    SessionDataset,
    chain_iterator,
    iterate_batches,
    stack_batches,
    to_device,
)
from gat_recommendation_torch.data.graph import load_edges
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.train import checkpoint as ckpt
from gat_recommendation_torch.train.metrics import compute_ndcg_at_k, compute_recall_at_k
from gat_recommendation_torch.train.trainer import make_chained_eval_step, make_eval_step
from gat_recommendation_torch.utils.io import save_json
from gat_recommendation_torch.utils.logging import get_logger

CHAIN = 16  # eval batches a chained dispatch


def load_model(ckpt_dir: Path, device: torch.device):
    """The model of a checkpoint, rebuilt from its meta.json and filled on `device`."""
    meta = ckpt.load_meta(ckpt_dir)
    cfg = dict(meta["model_config"])
    model = create_model(meta["model_name"], cfg.pop("num_items"), device="meta", **cfg)
    return ckpt.restore_params_state(ckpt_dir, model, device), meta


def evaluate_checkpoint(ckpt_dir: Path, test_ds, batch_size: int, k_values: list[int], device=None) -> dict:
    """{num_sessions, epoch, recall@k, ndcg@k for k in `k_values`} of the
    checkpoint over `test_ds`."""
    device = resolve_device(device)
    model, meta = load_model(Path(ckpt_dir), device)
    eval_step = make_eval_step(model, max(k_values))
    chained = make_chained_eval_step(model, max(k_values))
    tops, masks, targets = [], [], []
    for group in chain_iterator(iterate_batches(test_ds, batch_size=batch_size, shuffle=False), CHAIN):
        if len(group) < CHAIN:
            tops.extend(eval_step(to_device(batch, device)) for batch in group)
        else:
            top = chained(to_device(stack_batches(group), device))
            tops.append(top.reshape(-1, top.shape[-1]))
        masks.extend(np.asarray(batch.sample_mask) for batch in group)
        targets.extend(np.asarray(batch.targets) for batch in group)
    mask = np.concatenate(masks)
    predictions = torch.cat(tops).cpu().numpy()[mask]  # one readback
    targets_arr = np.concatenate(targets)[mask]

    metrics = {"num_sessions": int(len(targets_arr)), "epoch": meta["epoch"]}
    for k in k_values:
        metrics[f"recall@{k}"] = compute_recall_at_k(predictions, targets_arr, k)
        metrics[f"ndcg@{k}"] = compute_ndcg_at_k(predictions, targets_arr, k)
    return metrics


def load_test_split(test_sessions: str, graph_edges: str) -> SessionDataset:
    """The test split's dataset, its catalog size from split_info.json beside it."""
    split_info = json.loads((Path(test_sessions).parent / "split_info.json").read_text())
    return SessionDataset(test_sessions, load_edges(graph_edges), num_items=split_info["num_items"])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate checkpoints on the test split")
    parser.add_argument("--test-sessions", type=str, default="data/processed/test.csv")
    parser.add_argument("--graph-edges", type=str, default="data/processed/graph_edges.csv")
    parser.add_argument("--outputs-dir", type=str, default="outputs")
    parser.add_argument("--which", type=str, default="best", choices=["best", "latest"])
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--k-values", type=int, nargs="+", default=[10, 20])
    parser.add_argument("--results-file", type=str, default="outputs/evaluation_results.json")
    parser.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    logger = get_logger(__name__)
    device = resolve_device(args.device)
    test_ds = load_test_split(args.test_sessions, args.graph_edges)

    results = {}
    for model_dir in sorted(Path(args.outputs_dir).iterdir()):
        ckpt_dir = model_dir / f"checkpoint_{args.which}"
        if not (ckpt_dir / "meta.json").exists():
            continue
        logger.info(f"Evaluating {model_dir.name} ({args.which})...")
        try:
            results[model_dir.name] = evaluate_checkpoint(ckpt_dir, test_ds, args.batch_size, args.k_values,
                                                          device)
        except Exception as e:  # one model's failure is its row; the others still run
            logger.error(f"{model_dir.name}: {e}")
            results[model_dir.name] = {"error": str(e)}

    logger.info(f"{'model':32s} " + " ".join(f"{'r@%d' % k:>8s} {'n@%d' % k:>8s}" for k in args.k_values))
    for name, m in results.items():
        if "error" in m:
            logger.info(f"{name:32s} ERROR: {m['error']}")
        else:
            row = " ".join(f"{m[f'recall@{k}']:8.4f} {m[f'ndcg@{k}']:8.4f}" for k in args.k_values)
            logger.info(f"{name:32s} {row}")
    save_json(results, args.results_file)
    logger.info(f"Saved results to {args.results_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
