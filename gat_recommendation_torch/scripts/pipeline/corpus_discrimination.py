"""Corpus discrimination probe: do the four model families separate on a
given synthetic corpus?

    python3 -m gat_recommendation_torch.scripts.pipeline.corpus_discrimination \\
        --num-sessions 60000 --num-items 60000 --num-active 10000 --num-clusters 100 \\
        --max-epochs 70 --patience 15 [--device cpu]

The port of ``scripts/pipeline/corpus_discrimination.py``: every flag with
the same default, plus ``--device`` (``cuda`` unless told otherwise). The
reference's claim is an ordering (optimized Graph Transformer >> GAT >>
GraphSAGE on recall@10), and a corpus can only test it if it tells the
families apart. The probe makes a structured corpus
(``data/synthetic.generate_structured_events``), sessionizes, splits and
builds the graph with the port's data stages, then trains every model of
``--models`` with the eager sparse step (``Trainer(sparse_embedding_grads=
True, chain=16, record_hits=True)``: kernels 1, 2 and 3 on the card), and
writes ``<output-dir>/results.json``: the popularity baseline, each model's
best recall@10 with its bootstrap 95 % interval, best epoch and trajectory,
the order, and a paired bootstrap interval of the margin of every pair of
models (an edge of the order is settled only where its interval excludes 0).

The popularity baseline is the JAX script's pandas expression
``groupby("itemid").size().sort_values(ascending=False)`` without pandas:
the counts in item order, sorted as pandas sorts them (numpy's unstable
quicksort through ``data/ordering.pandas_argsort``), so that the top 10 and
20 end at the same items where they end inside a run of tied counts.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from gat_recommendation_torch.data.batching import SessionDataset, iterate_batches
from gat_recommendation_torch.data.graph import build_co_event_graph
from gat_recommendation_torch.data.ordering import pandas_argsort
from gat_recommendation_torch.data.sessionize import sessionize_events
from gat_recommendation_torch.data.splits import create_temporal_splits
from gat_recommendation_torch.data.synthetic import generate_structured_events
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.trainer import Trainer
from gat_recommendation_torch.utils.logging import get_logger


def bootstrap_ci(hits: np.ndarray, n_boot: int = 2000, seed: int = 0) -> tuple[float, float]:
    """95% bootstrap CI of a Bernoulli mean (per-session hit vector)."""
    rng = np.random.default_rng(seed)
    n = len(hits)
    idx = rng.integers(0, n, size=(n_boot, n))
    means = hits[idx].mean(axis=1)
    return float(np.quantile(means, 0.025)), float(np.quantile(means, 0.975))


def paired_margin_ci(hits_a: np.ndarray, hits_b: np.ndarray, n_boot: int = 2000, seed: int = 0) -> dict:
    """Paired bootstrap over sessions for recall(a) - recall(b).

    Both models are evaluated on the same validation sessions, so their hits
    are correlated; resampling sessions jointly gives a tighter interval on
    the margin than two independent intervals. The order of a and b is only
    resolved where the 95 % interval excludes zero.
    """
    rng = np.random.default_rng(seed)
    n = len(hits_a)
    diff = hits_a.astype(np.float64) - hits_b.astype(np.float64)
    idx = rng.integers(0, n, size=(n_boot, n))
    margins = diff[idx].mean(axis=1)
    lo, hi = float(np.quantile(margins, 0.025)), float(np.quantile(margins, 0.975))
    return {
        "margin": float(diff.mean()),
        "ci95": [round(lo, 5), round(hi, 5)],
        "resolved": bool(lo > 0 or hi < 0),
    }


def popularity_baselines(train: dict, val: dict) -> dict:
    """Recall@10 and @20 of the train split's most clicked items against the
    last item of each validation session."""
    items, counts = np.unique(np.asarray(train["itemid"]), return_counts=True)
    top = items[pandas_argsort(counts, ascending=False)]
    sid = np.asarray(val["session_id"])
    _, code = np.unique(sid, return_inverse=True)
    order = np.lexsort((np.asarray(val["timestamp"]), code.reshape(-1)))  # stable, as pandas' sort on two keys
    code, item = code.reshape(-1)[order], np.asarray(val["itemid"])[order]
    last = np.ones(len(code), dtype=bool)
    last[:-1] = code[1:] != code[:-1]
    targets = item[last]
    return {f"popularity_recall@{k}": float(np.mean([t in set(top[:k]) for t in targets])) for k in (10, 20)}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-sessions", type=int, default=30_000)
    p.add_argument("--num-items", type=int, default=60_000)
    p.add_argument("--num-active", type=int, default=None)
    p.add_argument("--num-clusters", type=int, default=None)
    p.add_argument("--noise-prob", type=float, default=0.15)
    p.add_argument("--repeat-prob", type=float, default=0.25)
    p.add_argument("--successors-per-item", type=int, default=8)
    p.add_argument("--cross-cluster-successors", type=int, default=2)
    p.add_argument("--dirichlet-alpha", type=float, default=0.4)
    p.add_argument("--mean-session-length", type=int, default=8)
    p.add_argument("--pop-exponent", type=float, default=1.05)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--max-epochs", type=int, default=40)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--embedding-dim", type=int, default=256)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--models", nargs="+", default=[
        "graph_transformer_optimized", "graph_transformer", "gat", "graphsage",
    ])
    p.add_argument("--output-dir", type=str, default="outputs/discrimination")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the probe; returns what it writes to ``results.json``."""
    args = parse_args(argv)
    logger = get_logger(__name__)
    device = resolve_device(args.device)

    t0 = time.time()
    events = generate_structured_events(
        num_sessions=args.num_sessions, num_items=args.num_items, seed=args.seed,
        num_active=args.num_active, num_clusters=args.num_clusters,
        noise_prob=args.noise_prob, repeat_prob=args.repeat_prob,
        successors_per_item=args.successors_per_item,
        cross_cluster_successors=args.cross_cluster_successors,
        dirichlet_alpha=args.dirichlet_alpha,
        mean_session_length=args.mean_session_length,
        pop_exponent=args.pop_exponent,
    )
    sessions = sessionize_events(events)
    train, val, _test, info = create_temporal_splits(sessions)
    graph, gstats = build_co_event_graph(train)
    edges = (graph["item_i"].astype(np.int64), graph["item_j"].astype(np.int64))
    num_items = info["num_items"]
    train_ds = SessionDataset(train, edges, num_negatives=5, num_items=num_items)
    val_ds = SessionDataset(val, edges, num_negatives=5, num_items=num_items)
    logger.info(
        f"[{time.time() - t0:.1f}s] {len(train_ds)}/{len(val_ds)} train/val sessions, "
        f"graph {gstats['num_nodes']} nodes / {gstats['num_edges']} edges"
    )

    # Popularity baseline: must stay weak for the probe to mean anything.
    baselines = popularity_baselines(train, val)
    logger.info(f"baselines: {baselines}")

    out_root = Path(args.output_dir)
    results: dict = {"config": vars(args), "baselines": baselines, "models": {}}
    best_hits: dict[str, np.ndarray] = {}
    for name in args.models:
        t0 = time.time()
        model = create_model(name, num_items=num_items, embedding_dim=args.embedding_dim,
                             hidden_dim=args.embedding_dim, device=device)
        mk = lambda ds, shuffle: lambda epoch=0: iterate_batches(  # noqa: E731
            ds, batch_size=args.batch_size, shuffle=shuffle, seed=epoch if shuffle else 0
        )
        trainer = Trainer(
            model,
            train_batches=mk(train_ds, True),
            val_batches=mk(val_ds, False),
            max_epochs=args.max_epochs,
            eval_every=1,
            patience=args.patience,
            checkpoint_every=10**9,  # a probe: no latest-checkpoint saves
            output_dir=out_root / name,
            k_values=[10, 20],
            loss_fn=create_loss_function("dual", 0.7),
            sparse_embedding_grads=True,
            chain=16,
            record_hits=True,
            device=device,
        )
        trainer.init_state()
        if model.uses_laplacian_pe:
            model.precompute_pe(*edges)
        trainer.train()
        r10 = [m["recall@10"] for m in trainer.history["val_metrics"]]
        best = int(np.argmax(r10))
        hits = np.asarray(trainer.hits[best], dtype=np.int8)
        best_hits[name] = hits
        lo, hi = bootstrap_ci(hits)
        results["models"][name] = {
            "best_recall@10": r10[best],
            "ci95": [round(lo, 5), round(hi, 5)],
            "best_epoch": best,
            "epochs_run": len(r10),
            "seconds": round(time.time() - t0, 1),
            "trajectory_recall@10": [round(x, 4) for x in r10],
        }
        logger.info(f"== {name}: best r@10 {r10[best]:.4f} [{lo:.4f}, {hi:.4f}] @ epoch {best}")

    order = sorted(results["models"], key=lambda k: -results["models"][k]["best_recall@10"])
    results["order"] = order
    pairs: dict = {}
    names = list(best_hits)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            pairs[f"{a} - {b}"] = paired_margin_ci(best_hits[a], best_hits[b])
    results["pairwise_margins"] = pairs
    results["unresolved_pairs"] = [k for k, v in pairs.items() if not v["resolved"]]
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "results.json").write_text(json.dumps(results, indent=2))
    logger.info("ORDER: " + " > ".join(order))
    for k, v in pairs.items():
        tag = "SETTLED" if v["resolved"] else "UNRESOLVED (CI contains 0)"
        logger.info(f"   {k}: {v['margin']:+.4f} {v['ci95']} {tag}")
    return results


if __name__ == "__main__":
    main()
