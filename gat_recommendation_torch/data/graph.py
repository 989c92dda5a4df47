"""Edge IO for the co-occurrence graph (npz packed, or the reference CSV).

Only the reader the serving path needs. The graph builder and writer stay in
the JAX package's data pipeline until the training slice ports them.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


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
    # The csv module, not a numeric parser: the reference CSV carries a quoted
    # JSON histogram column whose commas a plain split would misread.
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        ci, cj = header.index("item_i"), header.index("item_j")
        pairs = [(row[ci], row[cj]) for row in reader]
    arr = np.array(pairs, dtype=np.int64).reshape(-1, 2)
    return arr[:, 0].copy(), arr[:, 1].copy()
