#!/usr/bin/env python3
"""Export the serving artifacts of a trained model.

    python3 -m gat_recommendation_torch.scripts.pipeline.export_onnx --mode production \\
        --checkpoint outputs/graph_transformer_optimized/checkpoint_best [--device cpu]

The port of ``scripts/pipeline/export_onnx.py``: the same modes, flags,
defaults, files and metadata keys, plus ``--device`` (``cuda`` unless told
otherwise). It writes

  * ``item_embeddings.npy``: the item table, exactly as the checkpoint holds
    it (padded to a multiple of 512 rows, phantom rows included); the
    mean-embedding servers (``scripts/serve``) load it from ``MODEL_DIR``;
  * ``model_metadata.json``: mode, provenance, ``num_items`` (the table's
    rows) and ``embedding_dim``, the scorer check and its latency;

after checking the cosine scorer on the device (the table normalised once,
each request normalised and multiplied in float32 by ``torch.matmul``)
against a numpy oracle (a max difference above 1e-4 exits), and timing it
over ``--benchmark-requests`` single requests, each with its scores read
back to the host. The ONNX file of the same scoring layer is written only
where the ``onnx`` package is installed.

Modes: demo (a random table from ``default_rng(42)``), production (the table
of a checkpoint in the port's format; a lazy run's checkpoint holds the
materialized table, as the Trainer materializes before it saves), custom
(an ``.npy`` file).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.utils.io import save_json
from gat_recommendation_torch.utils.logging import get_logger


def cosine_scorer_numpy(session_emb: np.ndarray, item_emb: np.ndarray) -> np.ndarray:
    """Oracle: L2-normalize both sides, cosine scores."""
    s = session_emb / np.maximum(np.linalg.norm(session_emb, axis=-1, keepdims=True), 1e-12)
    e = item_emb / np.maximum(np.linalg.norm(item_emb, axis=-1, keepdims=True), 1e-12)
    return s @ e.T


def make_torch_scorer(item_emb: np.ndarray, device: torch.device):
    """The cosine scorer on `device`: [B, D] host sessions to [B, V] scores
    on the device (the caller reads them back)."""
    table = torch.from_numpy(item_emb).to(device)
    norm_table = table / torch.linalg.vector_norm(table, dim=-1, keepdim=True).clamp_min(1e-12)

    def score(session_emb: np.ndarray) -> torch.Tensor:
        s = torch.from_numpy(session_emb).to(device)
        s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.matmul(s, norm_table.T)

    return score


def export_onnx_scorer(item_emb: np.ndarray, out_path: Path, logger) -> bool:
    """Optional true ONNX export (opset 14, dynamic batch); False without onnx."""
    try:
        import onnx  # noqa: F401
    except ImportError:
        logger.warning("onnx unavailable; skipping ONNX file (the npy export is complete)")
        return False

    class SessionRecommender(torch.nn.Module):
        def __init__(self, emb):
            super().__init__()
            self.register_buffer("item_embeddings", torch.nn.functional.normalize(emb, dim=-1))

        def forward(self, session_embedding):
            s = torch.nn.functional.normalize(session_embedding, dim=-1)
            return s @ self.item_embeddings.t()

    model = SessionRecommender(torch.from_numpy(item_emb.copy()))
    dummy = torch.randn(1, item_emb.shape[1])
    torch.onnx.export(
        model, dummy, str(out_path), opset_version=14,
        input_names=["session_embedding"], output_names=["scores"],
        dynamic_axes={"session_embedding": {0: "batch"}, "scores": {0: "batch"}},
    )
    logger.info(f"Wrote ONNX scorer to {out_path}")
    return True


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Export serving artifacts")
    parser.add_argument("--mode", choices=["demo", "production", "custom"], default="demo")
    parser.add_argument("--checkpoint", type=str, default="outputs/graph_transformer_optimized/checkpoint_best")
    parser.add_argument("--embeddings-file", type=str, default=None, help="custom mode input .npy")
    parser.add_argument("--num-items", type=int, default=10_000, help="demo mode catalog size")
    parser.add_argument("--embedding-dim", type=int, default=256)
    parser.add_argument("--output-dir", type=str, default="exports")
    parser.add_argument("--benchmark-requests", type=int, default=50)
    parser.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Write the artifacts; returns the metadata written beside them."""
    args = parse_args(argv)
    logger = get_logger(__name__)
    device = resolve_device(args.device)

    meta: dict = {"mode": args.mode, "exported_at": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if args.mode == "demo":
        rng = np.random.default_rng(42)
        item_emb = rng.standard_normal((args.num_items, args.embedding_dim)).astype(np.float32)
    elif args.mode == "custom":
        item_emb = np.load(args.embeddings_file).astype(np.float32)
        meta["source"] = args.embeddings_file
    else:
        from gat_recommendation_torch.models.registry import create_model
        from gat_recommendation_torch.train import checkpoint as ckpt

        cmeta = ckpt.load_meta(args.checkpoint)
        cfg = dict(cmeta["model_config"])
        model = create_model(cmeta["model_name"], cfg.pop("num_items"), device="meta", **cfg)
        ckpt.restore_params_state(args.checkpoint, model, "cpu")  # the table stays on the host
        item_emb = model.item_embedding.detach().numpy()
        meta.update({"source": args.checkpoint, "model_name": cmeta["model_name"],
                     "epoch": cmeta["epoch"], "best_val_metric": cmeta["best_val_metric"]})

    num_items, embedding_dim = item_emb.shape
    meta.update({"num_items": int(num_items), "embedding_dim": int(embedding_dim)})

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "item_embeddings.npy", item_emb)
    logger.info(f"Wrote item_embeddings.npy ({item_emb.nbytes / 1e6:.1f} MB)")

    # The scorer on the device against the numpy oracle, in full float32.
    scorer = make_torch_scorer(item_emb, device)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, embedding_dim)).astype(np.float32)
    got = scorer(q).cpu().numpy()
    want = cosine_scorer_numpy(q, item_emb)
    max_diff = float(np.abs(got - want).max())
    meta["scorer_validation_max_diff"] = max_diff
    if max_diff > 1e-4:
        raise SystemExit(f"scorer validation failed: max diff {max_diff}")
    logger.info(f"Scorer validated vs numpy oracle (max diff {max_diff:.2e})")

    # Latency of one request: the session to the device, the scores back.
    lat = []
    for _ in range(args.benchmark_requests):
        q = rng.standard_normal((1, embedding_dim)).astype(np.float32)
        t0 = time.perf_counter()
        scorer(q).cpu().numpy()
        lat.append((time.perf_counter() - t0) * 1000)
    meta["scoring_latency_ms"] = {
        "p50": float(np.percentile(lat, 50)),
        "p95": float(np.percentile(lat, 95)),
        "mean": float(np.mean(lat)),
    }
    logger.info(f"Scoring latency p50={meta['scoring_latency_ms']['p50']:.2f}ms")

    meta["onnx_exported"] = export_onnx_scorer(item_emb, out / "session_recommender.onnx", logger)
    save_json(meta, out / "model_metadata.json")
    logger.info(f"Export complete -> {out}")
    return meta


if __name__ == "__main__":
    main()
