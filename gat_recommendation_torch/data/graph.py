"""The co-occurrence graph: the builder and the edge IO (npz packed, or the reference CSV).

``build_co_event_graph`` pairs items within ±window steps of each session,
orders each pair canonically (min, max) with the event pair and the source
timestamp swapped along with the items, keeps self-loops, and aggregates per
edge the count, the last canonical-source timestamp and the event-pair
histogram. It reads the four columns as arrays (numpy, no DataFrame; the
files go through ``data/csv_io.py``) and aggregates over an int64 pair key with ``np.unique``.
Rows and histogram keys come out in the JAX builder's order, so that
``save_edges`` writes its bytes: edges in the order their pair first occurs
(offset 1 first, then 2, ...), sorted by count descending with pandas'
unstable sort (``data/ordering.py``); each histogram's event pairs in the
order they first occur for that edge.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from gat_recommendation_torch.data.csv_io import read_csv, write_csv
from gat_recommendation_torch.data.ordering import pandas_argsort

DEFAULT_WINDOW = 5
EDGE_COLUMNS = ("item_i", "item_j", "count", "last_ts", "event_pair_hist")


def _columns(sessions) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(session_id, timestamp, itemid, event) from a tuple of the four arrays
    or a mapping with those keys; a scalar event stands for every row."""
    if isinstance(sessions, tuple):
        sid, ts, item, ev = sessions
    else:
        sid, ts, item, ev = (sessions[k] for k in ("session_id", "timestamp", "itemid", "event"))
    sid, ts, item = np.asarray(sid), np.asarray(ts, dtype=np.int64), np.asarray(item, dtype=np.int64)
    ev = np.asarray(ev)
    if ev.ndim == 0:
        ev = np.full(len(sid), ev.item())
    return sid, ts, item, ev


def build_co_event_graph(sessions, window: int = DEFAULT_WINDOW) -> tuple[dict, dict]:
    """Return ({item_i, item_j, count, last_ts: int64 arrays, event_pair_hist:
    a list of {"<src event>_<dst event>": count}}, stats)."""
    sid, ts, items, ev = _columns(sessions)
    order = np.lexsort((ts, sid))  # stable: equal (session, timestamp) keep their order
    sid, ts, items = sid[order], ts[order], items[order]
    event_names, ev_code = np.unique(ev[order].astype(str), return_inverse=True)
    ev_code = ev_code.reshape(-1).astype(np.int64)
    E = len(event_names)

    parts_i, parts_j, parts_ep, parts_t = [], [], [], []
    for d in range(1, window + 1):
        if d >= len(items):
            break
        same = sid[d:] == sid[:-d]
        a, b = items[:-d][same], items[d:][same]
        ea, eb = ev_code[:-d][same], ev_code[d:][same]
        ta, tb = ts[:-d][same], ts[d:][same]
        swap = a > b
        parts_i.append(np.where(swap, b, a))
        parts_j.append(np.where(swap, a, b))
        # The event pair (canonical source's event, canonical destination's)
        # as one code, and the canonical source's timestamp.
        parts_ep.append(np.where(swap, eb, ea) * E + np.where(swap, ea, eb))
        parts_t.append(np.where(swap, tb, ta))

    if not parts_i:
        empty = {k: np.zeros(0, np.int64) for k in EDGE_COLUMNS[:4]}
        return {**empty, "event_pair_hist": []}, {"num_nodes": 0, "num_edges": 0, "avg_degree": 0.0}

    pi, pj = np.concatenate(parts_i), np.concatenate(parts_j)
    pep, pt = np.concatenate(parts_ep), np.concatenate(parts_t)
    V = int(pj.max()) + 1
    keys, first, edge_of, count = np.unique(pi * V + pj, return_index=True, return_inverse=True,
                                            return_counts=True)
    edge_of = edge_of.reshape(-1)
    by_edge = np.argsort(edge_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(count)[:-1]])
    last_ts = np.maximum.reduceat(pt[by_edge], starts)

    # The histogram: counts per (edge, event pair), each edge's pairs in the
    # order they first occur.
    hist_keys, hist_first, hist_counts = np.unique(edge_of * (E * E) + pep, return_index=True,
                                                   return_counts=True)
    hist_edge, hist_pair = hist_keys // (E * E), hist_keys % (E * E)
    in_order = np.lexsort((hist_first, hist_edge))
    pair_names = [f"{a}_{b}" for a in event_names.tolist() for b in event_names.tolist()]
    if E == 1:
        hist = [{pair_names[0]: c} for c in hist_counts.tolist()]
    else:
        hist = [{} for _ in range(len(keys))]
        for e, p, c in zip(hist_edge[in_order].tolist(), hist_pair[in_order].tolist(),
                           hist_counts[in_order].tolist()):
            hist[e][pair_names[p]] = c

    appear = np.argsort(first, kind="stable")  # edges by first occurrence (pandas' groupby, sort=False)
    rows = appear[pandas_argsort(count[appear], ascending=False)]
    item_i, item_j = keys[rows] // V, keys[rows] % V
    count = count[rows].astype(np.int64)
    edges = {"item_i": item_i, "item_j": item_j, "count": count, "last_ts": last_ts[rows],
             "event_pair_hist": [hist[r] for r in rows.tolist()]}

    num_nodes = len(np.union1d(item_i, item_j))
    num_edges = len(count)
    stats = {
        "num_nodes": num_nodes,
        "num_edges": num_edges,
        "avg_degree": 2 * num_edges / num_nodes if num_nodes else 0.0,
        "edge_count_mean": float(count.mean()),
        "edge_count_median": float(np.median(count)),
        "edge_count_min": int(count.min()),
        "edge_count_max": int(count.max()),
    }
    return edges, stats


def save_edges(edges: dict, csv_path, npz_path=None) -> None:
    """The reference CSV (histogram as JSON) and, with `npz_path`, the packed
    npz of the four numeric columns that training and serving read."""
    hist = np.array([json.dumps(h) for h in edges["event_pair_hist"]], dtype=str)
    write_csv({**{k: np.asarray(edges[k]) for k in EDGE_COLUMNS[:4]}, "event_pair_hist": hist}, csv_path)
    if npz_path is not None:
        np.savez_compressed(npz_path, **{k: np.asarray(edges[k], dtype=np.int64) for k in EDGE_COLUMNS[:4]})


def load_edges(path) -> tuple[np.ndarray, np.ndarray]:
    """(item_i, item_j) int64 arrays from .npz (fast) or .csv (reference format)."""
    path = Path(path)
    if not path.exists():
        # Sibling-extension fallback: the packed npz is the committed form at
        # reference scale (the 67 MB CSV duplicate is not tracked); accept
        # either spelling so callers can pass the reference-parity .csv path.
        sibling = path.with_suffix(".npz" if path.suffix == ".csv" else ".csv")
        if sibling.exists():
            path = sibling
    if path.suffix == ".npz":
        with np.load(path) as z:
            return z["item_i"].astype(np.int64), z["item_j"].astype(np.int64)
    cols = read_csv(path, usecols=("item_i", "item_j"))  # a CSV reader: the histogram column holds commas
    return cols["item_i"].astype(np.int64), cols["item_j"].astype(np.int64)
