"""The deploy quality gate: artifact, metrics and latency of a checkpoint.

    python3 -m gat_recommendation_torch.scripts.pipeline.model_quality_gate [--checkpoint ...] ...

The port of ``scripts/pipeline/model_quality_gate.py``, three phases, exit
0 when every phase that ran passed and 1 otherwise:
  1. artifact: the checkpoint exists, its size is within the bounds, it
     loads, and no tensor holds NaN or Inf (one finite flag per tensor,
     reduced on the device, one readback);
  2. metrics: recall and NDCG at 10 and 20 on the test split
     (``evaluate_local.evaluate_checkpoint``) against the thresholds of
     ``configs/quality_thresholds.yaml``, which the ``--min-*`` flags override;
  3. latency: ``--latency-requests`` requests of 2-9 random items through the
     ``Recommender``, p50/p95/p99 against the SLO.
The results go to ``--results-file`` with the JAX gate's keys.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.scripts.evaluate_local import evaluate_checkpoint, load_model, load_test_split
from gat_recommendation_torch.serving.recommender import Recommender
from gat_recommendation_torch.serving.validation import ValidatedRequest
from gat_recommendation_torch.utils.io import load_config, save_json
from gat_recommendation_torch.utils.logging import get_logger


def load_thresholds(path: str, overrides: dict) -> dict:
    th = load_config(path)
    for key, val in overrides.items():
        if val is not None:
            th["metrics"][key] = val
    return th


def dir_size_mb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e6


def validate_artifact(ckpt_dir: Path, th: dict, device) -> tuple[bool, dict]:
    """Phase 1: exists, size bounds, loads, no NaN or Inf in any tensor."""
    result: dict = {"phase": "artifact"}
    if not (ckpt_dir / "meta.json").exists():
        result["error"] = f"checkpoint not found at {ckpt_dir}"
        return False, result
    size = dir_size_mb(ckpt_dir)
    result["size_mb"] = size
    if not (th["artifact"]["min_size_mb"] <= size <= th["artifact"]["max_size_mb"]):
        result["error"] = f"size {size:.1f}MB outside bounds"
        return False, result
    try:
        model, meta = load_model(ckpt_dir, device)
    except Exception as e:  # any loading fault is this phase's verdict
        result["error"] = f"checkpoint failed to load: {e}"
        return False, result
    tensors = [t for t in model.state_dict().values() if t.is_floating_point()]
    flags = torch.stack([torch.isfinite(t).all() for t in tensors]).cpu().numpy()
    result["nan_arrays"] = int((~flags).sum())
    if result["nan_arrays"]:
        result["error"] = f"{result['nan_arrays']} arrays contain NaN/Inf"
        return False, result
    result["model_name"] = meta["model_name"]
    return True, result


def validate_metrics(ckpt_dir: Path, test_sessions: str, graph_edges: str, th: dict, batch_size: int,
                     device) -> tuple[bool, dict]:
    """Phase 2: recall/ndcg on the test split against the thresholds."""
    metrics = evaluate_checkpoint(ckpt_dir, load_test_split(test_sessions, graph_edges), batch_size, [10, 20],
                                  device)
    result = {"phase": "metrics", **metrics, "thresholds": th["metrics"], "failures": []}
    for name, floor in th["metrics"].items():
        if metrics.get(name, 0.0) < floor:
            result["failures"].append(f"{name}={metrics.get(name, 0):.4f} < {floor}")
    return not result["failures"], result


def validate_latency(ckpt_dir: Path, graph_edges: str, th: dict, n_requests: int, device) -> tuple[bool, dict]:
    """Phase 3: per-request serving latency p50/p95/p99 against the SLO."""
    rec = Recommender(ckpt_dir, graph_edges, warmup=True, device=device)
    rng = np.random.default_rng(0)
    lat = []
    for _ in range(n_requests):
        items = rng.integers(1, rec.num_items, int(rng.integers(2, 10))).tolist()
        t0 = time.perf_counter()
        rec.recommend(ValidatedRequest(session_items=items, k=10))  # returns host lists: synchronized
        lat.append((time.perf_counter() - t0) * 1000)
    slo = th["latency_slo_ms"]
    result = {
        "phase": "latency",
        "p50": float(np.percentile(lat, 50)),
        "p95": float(np.percentile(lat, 95)),
        "p99": float(np.percentile(lat, 99)),
        "slo": slo,
        "failures": [],
    }
    for pct in ("p50", "p95", "p99"):
        if result[pct] > slo[pct]:
            result["failures"].append(f"{pct}={result[pct]:.1f}ms > {slo[pct]}ms")
    return not result["failures"], result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Model quality gate")
    parser.add_argument("--checkpoint", type=str, default="outputs/graph_transformer_optimized/checkpoint_best")
    parser.add_argument("--test-sessions", type=str, default="data/processed/test.csv")
    parser.add_argument("--graph-edges", type=str, default="data/processed/graph_edges.csv")
    parser.add_argument("--thresholds", type=str, default="configs/quality_thresholds.yaml")
    parser.add_argument("--min-recall-10", type=float, default=None)
    parser.add_argument("--min-recall-20", type=float, default=None)
    parser.add_argument("--min-ndcg-10", type=float, default=None)
    parser.add_argument("--min-ndcg-20", type=float, default=None)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--latency-requests", type=int, default=50)
    parser.add_argument("--skip-latency", action="store_true")
    parser.add_argument("--skip-metrics", action="store_true")
    parser.add_argument("--results-file", type=str, default="outputs/quality_gate_results.json")
    parser.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    logger = get_logger(__name__)
    device = resolve_device(args.device)
    th = load_thresholds(args.thresholds, {
        "recall@10": args.min_recall_10, "recall@20": args.min_recall_20,
        "ndcg@10": args.min_ndcg_10, "ndcg@20": args.min_ndcg_20,
    })
    ckpt_dir = Path(args.checkpoint)
    results: dict = {"checkpoint": args.checkpoint, "phases": {}}
    ok, res = validate_artifact(ckpt_dir, th, device)
    results["phases"]["artifact"] = res
    logger.info(f"Phase 1 artifact: {'PASS' if ok else 'FAIL'} {res.get('error', '')}")
    all_ok = ok

    if ok and not args.skip_metrics:
        mok, res = validate_metrics(ckpt_dir, args.test_sessions, args.graph_edges, th, args.batch_size, device)
        results["phases"]["metrics"] = res
        logger.info(f"Phase 2 metrics: {'PASS' if mok else 'FAIL'} {res.get('failures', '')}")
        all_ok &= mok

    if ok and not args.skip_latency:
        lok, res = validate_latency(ckpt_dir, args.graph_edges, th, args.latency_requests, device)
        results["phases"]["latency"] = res
        logger.info(f"Phase 3 latency: {'PASS' if lok else 'FAIL'} p50={res['p50']:.1f}ms {res.get('failures', '')}")
        all_ok &= lok

    results["pass"] = bool(all_ok)
    save_json(results, args.results_file)
    logger.info(f"Quality gate {'PASSED' if all_ok else 'FAILED'} -> {args.results_file}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
