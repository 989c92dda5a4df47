"""Recall@K / NDCG@K / stratified metrics over predicted-id matrices (numpy, host side)."""

from __future__ import annotations

import numpy as np


def compute_recall_at_k(predictions: np.ndarray, targets: np.ndarray, k: int) -> float:
    """Fraction of rows whose target appears in the first k predictions."""
    predictions = np.asarray(predictions)[:, :k]
    targets = np.asarray(targets)
    hits = (predictions == targets[:, None]).any(axis=1)
    return float(hits.mean()) if len(hits) else 0.0


def compute_ndcg_at_k(predictions: np.ndarray, targets: np.ndarray, k: int) -> float:
    """Single-relevant-item NDCG: 1/log2(pos+2) if target in top-k else 0."""
    predictions = np.asarray(predictions)[:, :k]
    targets = np.asarray(targets)
    matches = predictions == targets[:, None]
    has = matches.any(axis=1)
    pos = np.argmax(matches, axis=1)
    dcg = np.where(has, 1.0 / np.log2(pos + 2.0), 0.0)
    return float(dcg.mean()) if len(dcg) else 0.0


def compute_stratified_metrics(
    predictions: np.ndarray,
    targets: np.ndarray,
    strata: np.ndarray,
    k_values: list[int] | None = None,
) -> dict:
    """Per-stratum recall/ndcg, keyed ``stratum_<value>``."""
    if k_values is None:
        k_values = [10, 20]
    results: dict = {}
    strata = np.asarray(strata)
    for stratum in np.unique(strata):
        mask = strata == stratum
        entry: dict = {"count": int(mask.sum())}
        for k in k_values:
            entry[f"recall@{k}"] = compute_recall_at_k(predictions[mask], targets[mask], k)
            entry[f"ndcg@{k}"] = compute_ndcg_at_k(predictions[mask], targets[mask], k)
        results[f"stratum_{stratum}"] = entry
    return results
