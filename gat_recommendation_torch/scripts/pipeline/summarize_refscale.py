"""Summarize a reference-scale study directory into the EXPERIMENTS.md table.

    python3 -m gat_recommendation_torch.scripts.pipeline.summarize_refscale outputs/refscale_v3

The port of ``scripts/pipeline/summarize_refscale.py``, with its output to
the digit. It reads ``<study>/<model>/history.json`` (the validation
trajectories the Trainer writes), ``<study>/evaluation_results.json`` (the
test split's numbers from ``scripts.evaluate_local``) and
``<study>/quality_gate_results.json``, and prints (a) a GitHub-markdown table
of every model, (b) the models ordered by best validation recall@10, the
study's claim, and (c) where the runs recorded per-session hit vectors
(``train_baseline --record-hits``), paired bootstrap 95 % intervals of the
recall@10 margin of each adjacent pair of that order: 2,000 resamples drawn
from ``default_rng(0)`` in chunks of 100 (the JAX script's stream, so the
margins print the same digits). An edge of the order is settled only where
its interval excludes 0. Host code only: no device is touched.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from gat_recommendation_torch.train.hits_io import load_best_hits

DISPLAY = {
    "graph_transformer_optimized": "GT optimized",
    "graph_transformer": "GT (+FFN)",
    "gat": "GAT",
    "graphsage": "GraphSAGE",
}


def load_model_rows(study: Path) -> dict[str, dict]:
    """Per model directory with a non-empty history: the best validation
    epoch's metrics and the test split's."""
    eval_results = {}
    eval_file = study / "evaluation_results.json"
    if eval_file.exists():
        eval_results = json.loads(eval_file.read_text())
        eval_results = eval_results.get("models", eval_results)

    rows: dict[str, dict] = {}
    for hist_file in sorted(study.glob("*/history.json")):
        name = hist_file.parent.name
        vals = json.loads(hist_file.read_text()).get("val_metrics", [])
        if not vals:
            continue
        r10 = [m["recall@10"] for m in vals]
        best = max(range(len(r10)), key=r10.__getitem__)
        test = eval_results.get(name, {})
        if isinstance(test, dict) and "metrics" in test:
            test = test["metrics"]
        rows[name] = {
            "best_val_r10": r10[best],
            "best_val_n10": vals[best].get("ndcg@10"),
            "best_val_r20": vals[best].get("recall@20"),
            "best_epoch": best,
            "epochs_run": len(r10),
            "test_r10": test.get("recall@10"),
            "test_n10": test.get("ndcg@10"),
            "test_r20": test.get("recall@20"),
        }
    return rows


def fmt(x) -> str:
    return f"{x:.4f}" if isinstance(x, (int, float)) else "—"


def paired_margins(diff: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """2,000 bootstrap means of `diff`, drawn 100 resamples at a time (a
    single [2000, n] index matrix is several GB at reference-scale
    validation counts; the chunks draw the same stream)."""
    return np.concatenate([
        diff[rng.integers(0, len(diff), size=(chunk, len(diff)))].mean(axis=1)
        for chunk in [100] * 20
    ])


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("study_dir", type=Path)
    args = p.parse_args(argv)
    rows = load_model_rows(args.study_dir)
    if not rows:
        sys.exit(f"no */history.json under {args.study_dir}")

    order = sorted(rows, key=lambda k: -rows[k]["best_val_r10"])
    print("| Model | best val r@10 | val n@10 | val r@20 | test r@10 | test n@10 | test r@20 | epochs (best) |")
    print("|---|---|---|---|---|---|---|---|")
    for name in order:
        r = rows[name]
        print(
            f"| {DISPLAY.get(name, name)} | {fmt(r['best_val_r10'])} | {fmt(r['best_val_n10'])} "
            f"| {fmt(r['best_val_r20'])} | {fmt(r['test_r10'])} | {fmt(r['test_n10'])} "
            f"| {fmt(r['test_r20'])} | {r['epochs_run']} ({r['best_epoch']}) |"
        )

    print("\nordering by best val recall@10: " + " > ".join(DISPLAY.get(n, n) for n in order))

    hits = {}
    for name in order:
        hv = load_best_hits(args.study_dir / name, rows[name]["best_epoch"], k=10)
        if hv is not None:
            hits[name] = np.asarray(hv, dtype=np.float64)
    if len(hits) >= 2:
        rng = np.random.default_rng(0)
        print("\nadjacent ordering margins (paired bootstrap, 95% CI):")
        present = [n for n in order if n in hits]
        for a, b in zip(present, present[1:]):
            if len(hits[a]) != len(hits[b]):
                print(f"  {a} - {b}: hit vectors differ in length, skipped")
                continue
            diff = hits[a] - hits[b]
            lo, hi = np.quantile(paired_margins(diff, rng), [0.025, 0.975])
            tag = "SETTLED" if lo > 0 or hi < 0 else "UNRESOLVED (CI contains 0)"
            print(
                f"  {DISPLAY.get(a, a)} - {DISPLAY.get(b, b)}: "
                f"{diff.mean():+.4f} [{lo:+.4f}, {hi:+.4f}] {tag}"
            )

    gate = args.study_dir / "quality_gate_results.json"
    if gate.exists():
        g = json.loads(gate.read_text())
        print(f"quality gate: {'PASS' if g.get('pass') else 'FAIL'} ({gate})")


if __name__ == "__main__":
    main()
