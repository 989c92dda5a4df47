"""Bucketed fixed-shape session graphs: CSR graph, induced subgraphs, SessionBatch.

The host side is numpy, as in the JAX package's ``data/batching.py``: the
co-occurrence graph is pre-indexed as CSR adjacency, and each session's
induced subgraph becomes a dense boolean adjacency ``adj[b, dst, src]`` over
the bucket's node slots. ``SessionBatch`` holds the torch tensors one forward
pass reads. The bit-packed transfer form of the adjacency, the dataset and
the training iterators land with the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Node-count buckets. Sessions are truncated to the last 50 events, so unique
# context nodes <= 49 < 56; the largest bucket always fits and bigger node
# sets are truncated.
DEFAULT_BUCKETS = (8, 16, 32, 56)


def pick_bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; the largest bucket if none fits (truncation)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class SessionBatch:
    """One fixed-shape batch of padded session graphs (forward-pass fields).

    node_ids  [B, N] int32 — global item ids, ascending per session, 0-padded
    node_mask [B, N] bool  — valid node slots
    adj       [B, N, N] bool — adj[b, dst, src] = edge src->dst (local ids)
    num_nodes [B] int32    — valid node count per session
    """

    node_ids: torch.Tensor
    node_mask: torch.Tensor
    adj: torch.Tensor
    num_nodes: torch.Tensor

    def to(self, device) -> "SessionBatch":
        return SessionBatch(
            *(getattr(self, f.name).to(device) for f in dataclasses.fields(self))
        )


@dataclasses.dataclass
class CSRGraph:
    """Directed CSR adjacency over global item ids (rows sorted)."""

    indptr: np.ndarray  # [num_items + 1] int64
    indices: np.ndarray  # [num_edges] int32
    num_items: int


def build_csr(item_i, item_j, num_items: int) -> CSRGraph:
    """CSR from directed edges item_i -> item_j (duplicates preserved).

    The co-occurrence graph stores canonical (min, max) edges once; like the
    reference's subgraph builder this does NOT symmetrize — direction
    semantics are the model's concern, parity first."""
    item_i = np.asarray(item_i, dtype=np.int64)
    item_j = np.asarray(item_j, dtype=np.int64)
    order = np.lexsort((item_j, item_i))
    si, sj = item_i[order], item_j[order]
    counts = np.bincount(si, minlength=num_items)
    indptr = np.zeros(num_items + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=sj.astype(np.int32), num_items=num_items)


def induced_edges(graph: CSRGraph, nodes) -> tuple[np.ndarray, np.ndarray]:
    """Edges of the subgraph induced by `nodes` (sorted unique global ids).

    Returns (src_local, dst_local) int32 arrays indexing into `nodes`:
    a vectorized CSR row gather plus searchsorted membership.
    """
    nodes = np.asarray(nodes, dtype=np.int64)
    empty = np.zeros(0, dtype=np.int32)
    if len(nodes) == 0:
        return empty, empty
    starts = graph.indptr[nodes]
    counts = graph.indptr[nodes + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return empty, empty
    # Flat positions of every CSR entry belonging to a row in `nodes`.
    row_offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = np.repeat(starts - row_offsets, counts) + np.arange(total)
    dst_items = graph.indices[flat].astype(np.int64)
    src_local = np.repeat(np.arange(len(nodes), dtype=np.int32), counts)
    pos = np.searchsorted(nodes, dst_items)
    ok = (pos < len(nodes)) & (nodes[np.minimum(pos, len(nodes) - 1)] == dst_items)
    return src_local[ok], pos[ok].astype(np.int32)
