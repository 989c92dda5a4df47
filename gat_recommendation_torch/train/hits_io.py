"""Packed-bit storage for per-session hit vectors (``Trainer(record_hits=True)``).

The Trainer records one boolean vector per evaluation (did session i's target
land in the top-k at ``k_values[0]``) so that studies can compute paired
bootstrap intervals on recall margins between models trained on the same
split. One evaluation's vector is Bernoulli data, stored with ``np.packbits``
at one bit a session.

File format (``hits_k{k}.npz``, the JAX package's): ``packed`` uint8
[n_evals, ceil(max_n / 8)] and ``lengths`` int64 [n_evals], -1 marking an
evaluation whose vector is unknown (one from before a resume of a run that
did not record hits). Row i aligns with ``history["val_metrics"][i]``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_hits(path: str | Path, rows: list) -> None:
    """Write a list of per-evaluation hit vectors (arrays of 0/1, or None) as
    npz, under a temporary name renamed into place."""
    lengths = np.array([-1 if r is None else len(r) for r in rows], dtype=np.int64)
    max_len = int(max((int(n) for n in lengths if n >= 0), default=0))
    packed = np.zeros((len(rows), (max_len + 7) // 8), dtype=np.uint8)
    for i, r in enumerate(rows):
        if r is not None and len(r):
            bits = np.packbits(np.asarray(r, dtype=bool))
            packed[i, : bits.shape[0]] = bits
    tmp = Path(str(path) + ".tmp.npz")
    np.savez_compressed(tmp, packed=packed, lengths=lengths)
    tmp.replace(path)


def load_hits(path: str | Path) -> list:
    """Inverse of ``save_hits``: a list of int8 arrays (None for unknown evaluations)."""
    with np.load(path) as d:
        packed, lengths = d["packed"], d["lengths"]
    return [None if n < 0 else np.unpackbits(packed[i])[: int(n)].astype(np.int8)
            for i, n in enumerate(lengths)]
