"""Train a session-recommendation model (the Quickstart's training step).

    python3 -m gat_recommendation_torch.scripts.train.train_baseline [--lazy-adamw] [--max-epochs N] ...
    python3 -m gat_recommendation_torch.scripts.train.train_baseline --device cpu ...   # without a card

The port of ``scripts/train/train_baseline.py``: every flag with the same
default, plus ``--device`` (``cuda`` unless told otherwise; it raises where
there is no card). ``num_items`` comes from ``split_info.json`` beside the
train split; the datasets and the edges from the pipeline's files; the
optimizer is ``FusedEmbeddingAdamW`` (sparse gradients, eager or
``--lazy-adamw``, float32 or ``--bf16-moments``), or with
``--no-sparse-grads`` the same AdamW over dense gradients; the ``Trainer``
takes ``--chain``, ``--transfer-workers`` and ``--record-hits``, the batcher
``--workers``. Parameters are drawn (``init_state``) before the Laplacian
encodings are computed from the full graph, as in the JAX script. Outputs go
to ``<output-dir>/<model>/``; ``--resume`` goes on from its
``checkpoint_latest``; ``--gcs-bucket`` moves the inputs and outputs where
google-cloud-storage is installed.

One GPU only (ROADMAP A8): ``--mesh``, ``--n-model`` > 1 and a multi-process
launch raise; with more than one GPU visible the default mesh would be on,
so the script asks for ``--no-mesh`` instead of training on one in silence.

``parse_args``, ``build`` (datasets, model, optimizer, Trainer) and ``run``
stand apart so that a caller can set the weights between them; ``main``
chains them with ``initialize`` (parameters, then encodings).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

from gat_recommendation_torch.data.batching import SessionDataset, iterate_batches
from gat_recommendation_torch.data.graph import load_edges
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.models.registry import MODEL_NAMES, count_params, create_model
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import Trainer
from gat_recommendation_torch.utils.logging import get_logger
from gat_recommendation_torch.utils.seed import set_seed

MOMENT_DTYPES = {None: None, "both": torch.bfloat16, "mu": (torch.bfloat16, None), "nu": (None, torch.bfloat16)}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train session-recommendation models")
    p.add_argument("--model", type=str, default="graph_transformer_optimized", choices=list(MODEL_NAMES))
    p.add_argument("--train-sessions", type=str, default="data/processed/train.csv")
    p.add_argument("--val-sessions", type=str, default="data/processed/val.csv")
    p.add_argument("--graph-edges", type=str, default="data/processed/graph_edges.csv")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-negatives", type=int, default=5)
    p.add_argument("--max-session-length", type=int, default=50)
    p.add_argument("--embedding-dim", type=int, default=256)
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=None,
                   help="default: model-specific (2 for optimized GT, 3 otherwise)")
    p.add_argument("--num-heads", type=int, default=None)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--readout-type", type=str, default="mean", choices=["mean", "max", "last", "attention"])
    p.add_argument("--loss-type", type=str, default="dual", choices=["bpr", "listwise", "dual", "sampled_softmax"])
    p.add_argument("--alpha", type=float, default=0.7)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--max-epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="save checkpoint_latest on every Nth evaluation (best is saved on "
                        "improvement, the last trained epoch always)")
    p.add_argument("--output-dir", type=str, default="outputs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true", help="resume from checkpoint_latest")
    p.add_argument("--gcs-bucket", type=str, default=None)
    p.add_argument("--sparse-grads", action=argparse.BooleanOptionalAction, default=True,
                   help="sparse embedding gradients + the fused table AdamW; --no-sparse-grads "
                        "takes the dense step")
    p.add_argument("--transfer-workers", type=int, default=2, help="host-to-device transfer threads")
    p.add_argument("--workers", type=int, default=3, help="host batch-assembly threads")
    p.add_argument("--chain", type=int, default=32,
                   help="sparse steps a chained dispatch (CUDA graphs on the card); 1 disables")
    p.add_argument("--record-hits", action="store_true",
                   help="record per-session val hit vectors into hits_k{k}.npz")
    p.add_argument("--bf16-moments", nargs="?", const="both", default=None, choices=["both", "mu", "nu"],
                   help="table AdamW moments in bfloat16 with stochastic rounding (a value "
                        "narrows one buffer only)")
    p.add_argument("--lazy-adamw", action="store_true",
                   help="lazy catch-up AdamW for the table: O(touched rows) a step")
    p.add_argument("--no-sr-moments", action="store_true",
                   help="bf16 moments with round-to-nearest instead of stochastic rounding")
    p.add_argument("--distributed", choices=["auto", "off"], default="auto",
                   help="auto: a multi-process launch is detected (and raises: one GPU only)")
    p.add_argument("--mesh", action=argparse.BooleanOptionalAction, default=None,
                   help="train over a device mesh (not ported: raises); default on when more "
                        "than one GPU is visible")
    p.add_argument("--n-model", type=int, default=1, help="the mesh's 'model' axis (not ported)")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def multi_process_launch() -> bool:
    """A launcher started several processes (torchrun's WORLD_SIZE, or the
    coordinator variables the JAX script reads)."""
    env = os.environ
    return (int(env.get("WORLD_SIZE", "1")) > 1 or int(env.get("NUM_PROCESSES", "1")) > 1
            or bool(env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")))


def check_single_gpu(args: argparse.Namespace, device: torch.device) -> None:
    """Raise where the JAX script would train over a mesh or several processes."""
    if args.mesh or args.n_model > 1:
        raise NotImplementedError("training over a device mesh is not ported yet (ROADMAP A8); "
                                  "drop --mesh and --n-model")
    if args.distributed == "auto" and multi_process_launch():
        raise NotImplementedError("multi-process training is not ported yet (ROADMAP A8); "
                                  "launch one process, or pass --distributed off")
    if args.mesh is None and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} GPUs are visible, so the mesh would be on, and training "
            "over a mesh is not ported yet (ROADMAP A8); pass --no-mesh to train on one GPU")


def maybe_gcs_download(bucket: str | None, paths: list[str], logger) -> None:
    if not bucket:
        return
    try:
        from google.cloud import storage  # type: ignore
    except ImportError:
        logger.warning("google-cloud-storage not installed; skipping GCS download")
        return
    b = storage.Client().bucket(bucket)
    for path in paths:
        local = Path(path)
        local.parent.mkdir(parents=True, exist_ok=True)
        b.blob(path).download_to_filename(str(local))
        logger.info(f"gs://{bucket}/{path} -> {local}")


def maybe_gcs_upload(bucket: str | None, output_dir: Path, logger, client=None) -> int:
    """Upload every file under `output_dir` (checkpoints, history.json) to the
    bucket under its path relative to the output dir's parent; returns the
    file count. `client` is injectable for tests."""
    if not bucket:
        return 0
    if client is None:
        try:
            from google.cloud import storage  # type: ignore
        except ImportError:
            logger.warning("google-cloud-storage not installed; skipping GCS upload")
            return 0
        client = storage.Client()
    b = client.bucket(bucket)
    n = 0
    for f in sorted(output_dir.rglob("*")):
        if not f.is_file():
            continue
        remote = f.relative_to(output_dir.parent).as_posix()
        b.blob(remote).upload_from_filename(str(f))
        logger.info(f"{f} -> gs://{bucket}/{remote}")
        n += 1
    return n


def make_optimizer(args: argparse.Namespace) -> FusedEmbeddingAdamW:
    """The fused table AdamW as the flags ask for it; for the dense step
    (``--no-sparse-grads``) plain float32 AdamW, as the JAX script's
    ``optax.adamw`` (which ignores the moment flags)."""
    if not args.sparse_grads:
        return FusedEmbeddingAdamW(args.lr, weight_decay=args.weight_decay)
    return FusedEmbeddingAdamW(
        args.lr, weight_decay=args.weight_decay, moment_dtype=MOMENT_DTYPES[args.bf16_moments],
        stochastic_rounding=False if args.no_sr_moments else None, lazy=args.lazy_adamw,
    )


def build(args: argparse.Namespace):
    """(model, trainer, edges): the datasets from the pipeline's files, the
    model on the device, the optimizer and the Trainer. Draws no parameters."""
    logger = get_logger(__name__)
    device = resolve_device(args.device)
    check_single_gpu(args, device)
    set_seed(args.seed)
    split_info = Path(args.train_sessions).parent / "split_info.json"
    maybe_gcs_download(args.gcs_bucket, [args.train_sessions, args.val_sessions, args.graph_edges,
                                         str(split_info)], logger)
    num_items = json.loads(split_info.read_text())["num_items"]
    logger.info(f"Number of items: {num_items:,}")

    edges = load_edges(args.graph_edges)
    datasets = [SessionDataset(path, edges, num_negatives=args.num_negatives,
                               max_session_length=args.max_session_length, num_items=num_items)
                for path in (args.train_sessions, args.val_sessions)]
    train_ds, val_ds = datasets
    logger.info(f"Train sessions: {len(train_ds):,} | Val sessions: {len(val_ds):,}")

    model_kwargs: dict = dict(embedding_dim=args.embedding_dim, hidden_dim=args.hidden_dim,
                              dropout=args.dropout, readout_type=args.readout_type)
    if args.num_layers is not None:
        model_kwargs["num_layers"] = args.num_layers
    if args.num_heads is not None and args.model != "graphsage":
        model_kwargs["num_heads"] = args.num_heads
    model = create_model(args.model, num_items, device=device, **model_kwargs)

    trainer = Trainer(
        model,
        train_batches=lambda epoch: iterate_batches(train_ds, batch_size=args.batch_size, shuffle=True,
                                                    seed=args.seed + epoch, workers=args.workers),
        val_batches=lambda: iterate_batches(val_ds, batch_size=args.batch_size, shuffle=False, seed=0,
                                            workers=args.workers),
        optimizer=make_optimizer(args),
        output_dir=Path(args.output_dir) / args.model,
        max_epochs=args.max_epochs,
        patience=args.patience,
        eval_every=args.eval_every,
        checkpoint_every=args.checkpoint_every,
        loss_fn=create_loss_function(args.loss_type, args.alpha, args.temperature),
        seed=args.seed,
        sparse_embedding_grads=args.sparse_grads,
        chain=args.chain,
        record_hits=args.record_hits,
        transfer_workers=args.transfer_workers,
        device=device,
    )
    return model, trainer, edges


def initialize(args: argparse.Namespace, model, trainer: Trainer, edges) -> None:
    """Draw the parameters from the seed, then compute the Laplacian encodings
    from the full graph (in this order: drawing resets what it draws)."""
    logger = get_logger(__name__)
    trainer.init_state()
    num_items = model.config.num_items
    logger.info(f"Model parameters: {count_params(model) - num_items * args.embedding_dim:,} "
                f"(+ embedding table {num_items * args.embedding_dim:,})")
    if model.uses_laplacian_pe:
        logger.info("Precomputing Laplacian PE for the full graph...")
        model.precompute_pe(*edges)
        logger.info("Laplacian PE precomputed")


def run(args: argparse.Namespace, trainer: Trainer) -> dict:
    """Train (or resume) and upload the outputs; returns the history."""
    logger = get_logger(__name__)
    history = trainer.train(resume=args.resume)
    logger.info(f"Done. Best recall@10: {trainer.best_val_metric:.4f}")
    maybe_gcs_upload(args.gcs_bucket, Path(args.output_dir) / args.model, logger)
    return history


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    model, trainer, edges = build(args)
    initialize(args, model, trainer, edges)
    run(args, trainer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
