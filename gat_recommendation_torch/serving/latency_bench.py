"""Serving latency of the port: p50, p95 and p99 of ``Recommender.recommend``.

    python3 -m gat_recommendation_torch.serving.latency_bench \\
        --checkpoint outputs/run/checkpoint_best --graph-edges data/processed/graph_edges.npz

Measures the real per-request path (the induced subgraph on the host, the
Graph Transformer forward, full-catalog scoring with the seen items masked,
the exact top-k) against a checkpoint in the port's format, over 200 seeded
requests of 2 .. 11 items at k = 10. On the card unless ``--device cpu``.
Exact scoring only: the port has no int8 candidate scorer yet (ROADMAP A7),
so that mode is reported unavailable and skipped.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from gat_recommendation_torch.device import nvidia_smi
from gat_recommendation_torch.serving.recommender import Recommender
from gat_recommendation_torch.serving.validation import ValidatedRequest

logger = logging.getLogger(__name__)


def make_requests(num_items: int, n: int = 200, seed: int = 0) -> list[ValidatedRequest]:
    """`n` requests of 2 .. 11 items drawn from [1, num_items), k = 10."""
    rng = np.random.default_rng(seed)
    return [ValidatedRequest(session_items=[int(x) for x in rng.integers(1, num_items, rng.integers(2, 12))], k=10)
            for _ in range(n)]


def measure(rec: Recommender, reqs: list) -> dict:
    """Latency percentiles in ms over `reqs`, one ``recommend`` call each
    (it ends in a readback of the top-k, so each call waits for the card)."""
    lat = []
    for r in reqs:
        t0 = time.perf_counter()
        rec.recommend(r)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.array(lat)
    return {
        "p50": float(np.percentile(lat, 50)),
        "p95": float(np.percentile(lat, 95)),
        "p99": float(np.percentile(lat, 99)),
        "n": len(lat),
    }


def run(checkpoint, graph_edges, num_requests: int = 200, device=None) -> dict:
    """Load a warmed Recommender and measure the exact mode."""
    t0 = time.perf_counter()
    rec = Recommender(checkpoint, graph_edges, warmup=True, device=device)
    load_s = time.perf_counter() - t0
    results: dict = {"device": str(rec.device), "card": nvidia_smi() if rec.device.type == "cuda" else None}
    results["exact"] = {**measure(rec, make_requests(rec.num_items, num_requests)), "load_warmup_s": load_s}
    logger.info("exact: %s", results["exact"])
    logger.warning("int8 scoring unavailable: the port has no int8 candidate scorer yet (ROADMAP A7)")
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--graph-edges", required=True)
    p.add_argument("--num-requests", type=int, default=200)
    p.add_argument("--results-file", type=str, default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    results = run(args.checkpoint, args.graph_edges, args.num_requests, args.device)
    print(json.dumps(results))
    if args.results_file:
        Path(args.results_file).parent.mkdir(parents=True, exist_ok=True)
        Path(args.results_file).write_text(json.dumps(results, indent=2))
        logger.info("wrote %s", args.results_file)


if __name__ == "__main__":
    main()
