"""The optional contiguous item-id remap, on column dicts (no pandas).

The JAX package's ``data/remap.py``: the table is sized by the raw max id +
1, far more rows than items that occur; this maps the raw ids that occur to
1 .. num_unique (0 stays the padding id), and the map ships with the
artifacts so that serving can translate back.
"""

from __future__ import annotations

import numpy as np


def build_id_map(*frames_and_edges) -> np.ndarray:
    """Ascending unique raw item ids over every input: column dicts (or
    mappings) with an ``itemid`` column and (item_i, item_j) edge tuples.
    Position k maps raw id -> contiguous id k + 1."""
    pools = []
    for x in frames_and_edges:
        if isinstance(x, tuple):
            item_i, item_j = x
            pools.append(np.asarray(item_i, np.int64))
            pools.append(np.asarray(item_j, np.int64))
        else:
            pools.append(np.asarray(x["itemid"], np.int64))
    # A raw id 0 gets a live slot like any other (it would collide with the
    # padding row if the raw ids were kept).
    return np.unique(np.concatenate(pools))


def _lookup(raw_ids: np.ndarray, id_map: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(id_map, raw_ids)
    ok = (pos < len(id_map)) & (id_map[np.minimum(pos, len(id_map) - 1)] == raw_ids)
    if not ok.all():
        missing = np.asarray(raw_ids)[~ok][:5]
        raise KeyError(f"raw item ids not in id map (first few: {missing.tolist()})")
    return (pos + 1).astype(np.int64)


def remap_sessions(columns: dict, id_map: np.ndarray) -> dict:
    """A copy of the columns with ``itemid`` mapped to contiguous ids."""
    return {**columns, "itemid": _lookup(np.asarray(columns["itemid"], np.int64), id_map)}


def remap_edges(item_i, item_j, id_map: np.ndarray):
    return _lookup(np.asarray(item_i, np.int64), id_map), _lookup(np.asarray(item_j, np.int64), id_map)
