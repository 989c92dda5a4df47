"""The one traffic generator: the session corpus and its co-occurrence edges.

A traffic file's ``corpus`` block gives the parameters. The sessions are
RetailRocket-shaped (``corpus_columns``, a frozen copy of the program's
``bench.corpus_columns``): geometric lengths clipped to [min_length,
max_length], Zipf item popularity over a permuted catalog. The sessions
and their items come from the fixed ``structure_seed`` of each split, so
every ``--seed`` gets the same set of sessions, buckets and graph (the
canonical direction of an edge, and with it the length of every CSR row the
batch engine scans, depends on the items' labels); ``--seed`` permutes the
session ids, so the order of the dataset, every epoch order and every
batch's content change with it. The edges are the
canonical (min, max) item pairs within ``window`` events of each training
session, self-loops kept, each pair once (what the program's
``data/graph.build_co_event_graph`` aggregates; its counts and histograms
are not read by training).
"""

from __future__ import annotations

import numpy as np


def corpus_columns(num_sessions: int, num_items: int, seed: int, p: float = 0.25, min_length: int = 3,
                   max_length: int = 50, zipf: float = 1.2):
    """(session_id, timestamp, itemid) int64 columns; the numpy streams of
    ``bench.corpus_columns`` (whose parameters are the defaults here)."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.geometric(p, num_sessions) + 2, min_length, max_length)
    total = int(lengths.sum())
    ranks = np.arange(1, num_items, dtype=np.float64)
    probs = ranks ** -zipf
    cum = np.cumsum(probs / probs.sum())
    perm = rng.permutation(num_items - 1)
    items = perm[np.minimum(np.searchsorted(cum, rng.random(total)), num_items - 2)] + 1
    return np.repeat(np.arange(num_sessions), lengths), np.arange(total, dtype=np.int64), items


def co_event_edges(sid: np.ndarray, ts: np.ndarray, items: np.ndarray, window: int):
    """(item_i, item_j) int64: each canonical pair of items at most `window`
    events apart in one session, once, sorted."""
    order = np.lexsort((ts, sid))
    sid, items = sid[order], items[order].astype(np.int64)
    keys = []
    for d in range(1, window + 1):
        same = sid[d:] == sid[:-d]
        a, b = items[:-d][same], items[d:][same]
        keys.append(np.minimum(a, b) * (1 << 32) + np.maximum(a, b))
    keys = np.unique(np.concatenate(keys)) if keys else np.zeros(0, np.int64)
    return keys >> 32, keys & 0xFFFFFFFF


def make(corpus: dict, num_items: int, seed: int) -> dict:
    """{"train": (sid, ts, items), "val": (sid, ts, items), "edges": (item_i, item_j)}
    for one `seed`."""
    shape = dict(p=corpus["geometric_p"], min_length=corpus["min_length"], max_length=corpus["max_length"],
                 zipf=corpus["zipf"])
    out = {}
    for k, split in enumerate(("train", "val")):
        spec = corpus[split]
        sid, ts, items = corpus_columns(spec["sessions"], num_items, spec["structure_seed"], **shape)
        sessions = np.random.default_rng([seed, 2 + k]).permutation(spec["sessions"])
        out[split] = (sessions[sid].astype(np.int64), ts, items.astype(np.int64))
    out["edges"] = co_event_edges(*out["train"], corpus["window"])
    return out
