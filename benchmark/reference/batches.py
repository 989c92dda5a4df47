"""The batches, derived again from the raw sessions and edges.

The semantics the program states for its batch engine: sessions in sorted
session-id order, each stable-sorted by time and cut to its last
``max_length`` events; a session's bucket is the smallest of ``buckets``
holding its unique context items (every event but the last); an epoch takes
the sessions in ``default_rng(seed).permutation`` order (in index order
without shuffling), groups them by bucket (ascending) and cuts each bucket
into batches of ``batch_size`` slots, the last padded. A slot holds the
session's sorted unique context items as nodes, ``adj[dst, src]`` for every
directed edge src -> dst among them, the last event as target and the
negatives of ``hashing.negatives`` (seeded by the batch's engine seed and the
slot).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference import hashing

BUCKETS = (8, 16, 32, 56)


@dataclass
class Sessions:
    items: np.ndarray  # int64, every session's kept events in time order
    offsets: np.ndarray  # int64 [S + 1]
    unique_counts: np.ndarray  # int64 [S]

    @classmethod
    def from_columns(cls, sid, ts, items, max_length: int) -> "Sessions":
        _, codes = np.unique(sid, return_inverse=True)
        codes = codes.reshape(-1)
        order = np.lexsort((ts, codes))
        codes, items = codes[order], np.asarray(items, np.int64)[order]
        counts = np.bincount(codes)
        starts = np.cumsum(counts) - counts
        keep_len = np.minimum(counts, max_length)
        keep = np.arange(len(items)) - starts[codes] >= (counts - keep_len)[codes]
        offsets = np.concatenate([[0], np.cumsum(keep_len)]).astype(np.int64)
        kept = items[keep]
        # Unique context items a session: sort (session, item) pairs without
        # each session's last event and count the changes.
        code = np.repeat(np.arange(len(counts)), keep_len)
        context = np.ones(len(kept), bool)
        context[offsets[1:] - 1] = False
        c, it = code[context], kept[context]
        order = np.lexsort((it, c))
        c, it = c[order], it[order]
        new = np.ones(len(c), bool)
        new[1:] = (c[1:] != c[:-1]) | (it[1:] != it[:-1])
        return cls(kept, offsets, np.bincount(c[new], minlength=len(counts)))

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def session(self, s: int) -> np.ndarray:
        return self.items[self.offsets[s]:self.offsets[s + 1]]


def bucket_of(n: int, buckets=BUCKETS) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


def schedule(sessions: Sessions, batch_size: int, seed: int, shuffle: bool, buckets=BUCKETS) -> list:
    """[(session indices, bucket N, batch index)] of one epoch, in order."""
    order = np.random.default_rng(seed).permutation(len(sessions)) if shuffle else np.arange(len(sessions))
    by_bucket: dict[int, list[int]] = {b: [] for b in buckets}
    for s in order:
        by_bucket[bucket_of(int(sessions.unique_counts[s]), buckets)].append(int(s))
    out = []
    for b in buckets:
        idx = by_bucket[b]
        for lo in range(0, len(idx), batch_size):
            out.append((idx[lo:lo + batch_size], b, len(out)))
    return out


def csr(item_i, item_j, num_items: int) -> tuple[np.ndarray, np.ndarray]:
    """(indptr, sorted neighbours) of the directed edges item_i -> item_j."""
    item_i, item_j = np.asarray(item_i, np.int64), np.asarray(item_j, np.int64)
    order = np.lexsort((item_j, item_i))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(item_i, minlength=num_items))])
    return indptr, item_j[order]


def assemble(sessions: Sessions, graph, chunk: list, batch_size: int, n: int, seed: int, batch_index: int,
             num_items: int, k: int) -> dict:
    """One batch as numpy arrays: node_ids, node_mask, adj [B, N, N] bool
    (adj[b, dst, src]), num_nodes, targets, negatives, sample_mask."""
    indptr, nbrs = graph
    out = {
        "node_ids": np.zeros((batch_size, n), np.int64), "node_mask": np.zeros((batch_size, n), bool),
        "adj": np.zeros((batch_size, n, n), bool), "num_nodes": np.zeros(batch_size, np.int64),
        "targets": np.zeros(batch_size, np.int64), "negatives": np.zeros((batch_size, k), np.int64),
        "sample_mask": np.zeros(batch_size, bool),
    }
    bseed = hashing.batch_seed(seed, batch_index)
    for slot, s in enumerate(chunk):
        items = sessions.session(s)
        nodes = np.unique(items[:-1])[:n]
        m = len(nodes)
        out["node_ids"][slot, :m] = nodes
        out["node_mask"][slot, :m] = True
        out["num_nodes"][slot] = m
        for src, u in enumerate(nodes):
            row = nbrs[indptr[u]:indptr[u + 1]]
            hit = np.searchsorted(nodes, row)
            ok = hit < m
            ok[ok] = nodes[hit[ok]] == row[ok]
            out["adj"][slot, hit[ok], src] = True
        out["targets"][slot] = items[-1]
        out["negatives"][slot] = hashing.negatives(bseed, slot, items, num_items, k)
        out["sample_mask"][slot] = True
    return out
