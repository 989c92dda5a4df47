"""The temporal 70/15/15 session split with blackout windows, without pandas.

The JAX package's ``data/splits.py`` on column dicts: each session's start
and end time; sessions in session-id order, then sorted by start time
(pandas' default quicksort, reproduced by ``pandas_argsort``); cut points by
index at the train and train + val ratios; a window of ``blackout_days``
after each cut whose sessions are dropped; each remaining event keeps its
row order. ``split_info`` has the JAX package's keys in its order;
``num_items`` is the raw max item id + 1.
"""

from __future__ import annotations

import numpy as np

from gat_recommendation_torch.data.ordering import pandas_argsort, value_counts

MS_PER_DAY = 24 * 60 * 60 * 1000


def create_temporal_splits(
    sessions: dict,
    train_ratio: float = 0.70,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    blackout_days: int = 2,
) -> tuple[dict, dict, dict, dict]:
    """Return (train, val, test, split_info); blackout sessions are dropped."""
    sid = np.asarray(sessions["session_id"])
    ts = np.asarray(sessions["timestamp"], dtype=np.int64)
    _, code, counts = np.unique(sid, return_inverse=True, return_counts=True)
    code = code.reshape(-1)
    by_session = np.argsort(code, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    start = np.minimum.reduceat(ts[by_session], starts)
    end = np.maximum.reduceat(ts[by_session], starts)
    order = pandas_argsort(start)  # the sessions' positions by start time
    start_sorted, end_sorted = start[order], end[order]

    n = len(order)
    train_end_idx = int(n * train_ratio)
    val_end_idx = int(n * (train_ratio + val_ratio))
    train_end_ts = int(end_sorted[train_end_idx - 1])
    val_end_ts = int(end_sorted[val_end_idx - 1])
    blackout_ms = blackout_days * MS_PER_DAY
    train_blackout_end = train_end_ts + blackout_ms
    val_blackout_end = val_end_ts + blackout_ms

    labels = np.select(
        [end_sorted <= train_end_ts, start_sorted <= train_blackout_end,
         end_sorted <= val_end_ts, start_sorted <= val_blackout_end],
        ["train", "blackout_1", "val", "blackout_2"],
        default="test",
    )
    split_counts = value_counts(labels)
    session_split = np.empty(n, dtype=labels.dtype)
    session_split[order] = labels
    event_split = session_split[code]

    def part(name: str) -> dict:
        rows = np.flatnonzero(event_split == name)
        return {k: np.asarray(v)[rows] for k, v in sessions.items()}

    train_df, val_df, test_df = part("train"), part("val"), part("test")
    item = np.asarray(sessions["itemid"], dtype=np.int64)
    split_info = {
        "train_ratio": train_ratio,
        "val_ratio": val_ratio,
        "test_ratio": test_ratio,
        "blackout_days": blackout_days,
        "train_sessions": int(len(np.unique(train_df["session_id"]))),
        "val_sessions": int(len(np.unique(val_df["session_id"]))),
        "test_sessions": int(len(np.unique(test_df["session_id"]))),
        "train_events": int(len(train_df["session_id"])),
        "val_events": int(len(val_df["session_id"])),
        "test_events": int(len(test_df["session_id"])),
        "blackout_1_sessions": int(split_counts.get("blackout_1", 0)),
        "blackout_2_sessions": int(split_counts.get("blackout_2", 0)),
        "train_end_ts": train_end_ts,
        "val_end_ts": val_end_ts,
        "train_blackout_end_ts": train_blackout_end,
        "val_blackout_end_ts": val_blackout_end,
        "num_items": int(item.max()) + 1,
    }
    return train_df, val_df, test_df, split_info
