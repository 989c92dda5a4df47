"""Run the ablation matrix of ``configs/ablations.yaml``.

    python3 -m gat_recommendation_torch.scripts.train.run_ablations [--ablations no_ffn loss_bpr] [--device cpu]

The port of ``scripts/train/run_ablations.py``: every flag with the same
default, plus ``--device`` (``cuda`` unless told otherwise). Each ablation
overrides the config's ``base``, trains for ``--max-epochs`` on the processed
data (the dense step with ``FusedEmbeddingAdamW(1e-3, weight_decay=1e-5)``,
the JAX script's ``optax.adamw``: kernel 4 updates the table), and records
the last validation metrics; the results land in one JSON table. Each run
writes its checkpoints under ``outputs/ablations/<name>`` of the working
directory, as the JAX script does.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from gat_recommendation_torch.data.batching import SessionDataset, iterate_batches
from gat_recommendation_torch.data.graph import load_edges
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import Trainer
from gat_recommendation_torch.utils.io import load_config, save_json
from gat_recommendation_torch.utils.logging import get_logger

MODEL_KEYS = {
    "embedding_dim", "hidden_dim", "num_layers", "num_heads", "dropout",
    "readout_type", "use_laplacian_pe", "laplacian_k", "use_ffn",
    "ffn_expansion", "aggregator", "concat_heads",
}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Run ablation matrix")
    parser.add_argument("--config", type=str, default="configs/ablations.yaml")
    parser.add_argument("--ablations", nargs="*", default=None,
                        help="subset of ablation names (default: all)")
    parser.add_argument("--train-sessions", type=str, default="data/processed/train.csv")
    parser.add_argument("--val-sessions", type=str, default="data/processed/val.csv")
    parser.add_argument("--graph-edges", type=str, default="data/processed/graph_edges.csv")
    parser.add_argument("--max-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--results-file", type=str, default="outputs/ablation_results.json")
    parser.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Train every ablation asked for; returns the table it writes."""
    args = parse_args(argv)
    logger = get_logger(__name__)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    base = cfg["base"]
    names = args.ablations or list(cfg["ablations"])

    split_info = json.loads((Path(args.train_sessions).parent / "split_info.json").read_text())
    edges = load_edges(args.graph_edges)
    train_ds = SessionDataset(args.train_sessions, edges, num_items=split_info["num_items"])
    val_ds = SessionDataset(args.val_sessions, edges, num_items=split_info["num_items"])

    results = {}
    for name in names:
        t0 = time.perf_counter()
        merged = {**base, **cfg["ablations"][name]}
        model_name = merged.pop("model", base.get("model", "graph_transformer_optimized"))
        loss_type = merged.pop("loss_type", "dual")
        model_kwargs = {k: v for k, v in merged.items() if k in MODEL_KEYS}
        model = create_model(model_name, split_info["num_items"], device=device, **model_kwargs)

        trainer = Trainer(
            model,
            train_batches=lambda e: iterate_batches(train_ds, args.batch_size, seed=e),
            val_batches=lambda: iterate_batches(val_ds, args.batch_size, shuffle=False),
            optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5),
            output_dir=Path("outputs/ablations") / name,
            max_epochs=args.max_epochs,
            loss_fn=create_loss_function(loss_type),
            device=device,
        )
        trainer.init_state()
        if model.uses_laplacian_pe:
            model.precompute_pe(*edges)
        history = trainer.train()
        final = history["val_metrics"][-1] if history["val_metrics"] else {}
        results[name] = {**final, "seconds": time.perf_counter() - t0,
                         "config": {**model_kwargs, "loss_type": loss_type}}
        logger.info(f"{name}: {final} ({results[name]['seconds']:.1f}s)")

    save_json(results, args.results_file)
    logger.info(f"Ablation results -> {args.results_file}")
    return results


if __name__ == "__main__":
    main()
