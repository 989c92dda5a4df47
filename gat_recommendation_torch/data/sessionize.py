"""Sessionization without pandas: a 30-min inactivity gap, per-visitor
boundaries, sessions of at least 3 events.

The JAX package's ``data/sessionize.py`` on column dicts: events sorted
stably by (visitor, timestamp); a new session at a visitor change or a gap
strictly greater than ``gap_minutes``; sessions shorter than
``min_length`` dropped and the rest numbered ``sess_0``, ``sess_1``, ... in
that order.
"""

from __future__ import annotations

import numpy as np

from gat_recommendation_torch.data.ordering import value_counts

DEFAULT_GAP_MINUTES = 30
DEFAULT_MIN_LENGTH = 3


def _take(columns: dict, rows: np.ndarray) -> dict:
    return {k: np.asarray(v)[rows] for k, v in columns.items()}


def sessionize_events(
    events: dict, gap_minutes: int = DEFAULT_GAP_MINUTES, min_length: int = DEFAULT_MIN_LENGTH
) -> dict:
    """The events (columns as in ``data/synthetic.py``) in session order with
    a ``session_id`` column added; sessions shorter than `min_length` dropped."""
    visitor = np.asarray(events["visitorid"])
    ts = np.asarray(events["timestamp"], dtype=np.int64)
    _, visitor_code = np.unique(visitor, return_inverse=True)
    order = np.lexsort((ts, visitor_code.reshape(-1)))
    df = _take(events, order)
    visitor, ts = visitor[order], ts[order]

    new_session = np.ones(len(ts), dtype=bool)
    if len(ts) > 1:
        new_session[1:] = (visitor[1:] != visitor[:-1]) | ((ts[1:] - ts[:-1]) > gap_minutes * 60_000)
    raw_sid = np.cumsum(new_session) - 1

    counts = np.bincount(raw_sid) if len(raw_sid) else np.zeros(0, np.int64)
    keep = counts[raw_sid] >= min_length
    df = _take(df, np.flatnonzero(keep))
    _, consecutive = np.unique(raw_sid[keep], return_inverse=True)
    df["session_id"] = np.char.add("sess_", consecutive.reshape(-1).astype(np.str_))
    return df


def compute_session_stats(sessions: dict) -> dict:
    """Summary statistics of sessionized events (the stats JSON), with the
    JAX package's keys, values and order."""
    sid = np.asarray(sessions["session_id"])
    ts = np.asarray(sessions["timestamp"], dtype=np.int64)
    _, code, lengths = np.unique(sid, return_inverse=True, return_counts=True)
    code = code.reshape(-1)
    by_session = np.argsort(code, kind="stable")
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    durations = (np.maximum.reduceat(ts[by_session], starts) - np.minimum.reduceat(ts[by_session], starts))
    return {
        "num_events": int(len(sid)),
        "num_sessions": int(len(lengths)),
        "num_visitors": int(len(np.unique(sessions["visitorid"]))),
        "num_unique_items": int(len(np.unique(sessions["itemid"]))),
        "session_length_min": int(lengths.min()),
        # pandas' mean: a float64 sum over the count.
        "session_length_mean": float(np.sum(lengths, dtype=np.float64) / len(lengths)),
        "session_length_median": float(np.median(lengths)),
        "session_length_max": int(lengths.max()),
        "session_duration_mean_s": float(np.sum(durations, dtype=np.float64) / len(durations) / 1000.0),
        "event_counts": value_counts(np.asarray(sessions["event"])),
    }
