"""What a traced run counts on the host, around the program's feed.

``Observer.wrap`` stands between ``iterate_batches`` and its consumer (the
Trainer's prefetch thread, or ``evaluate``): it times each ``next()`` (the
wait for the batch engine as its consumer sees it) and counts each batch's
work: valid sessions, their real nodes and edges, and the bit-packed
adjacency rows they need. With `track_rows` (training) it follows the
table's rows from the first step on, as the lazy optimizer meets them: the
unique rows a step touches (the padding row 0 left out) and the catch-up
terms of those touched before (steps missed, at most the tail's 64; a row
never touched has zero moments and no series). Only what falls inside the
observed window is kept; once that window has closed (``close``), it passes
the batches straight through, so that the run's unobserved window carries
none of its work.
"""

from __future__ import annotations

import time

import numpy as np

TAIL_TERMS = 64


class Observer:
    def __init__(self, num_items: int, track_rows: bool):
        self.recording = False
        self.closed = False
        self.waits: list[float] = []
        self.batches: list[dict] = []
        self.last = np.zeros(num_items, np.int64) if track_rows else None
        self.step = 0

    def wrap(self, iterator):
        it = iter(iterator)
        try:
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                if not self.closed:
                    wait = time.perf_counter() - t
                    stats = self.count(batch)
                    if self.recording:
                        self.waits.append(wait)
                        self.batches.append(stats)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def close(self) -> None:
        self.recording, self.closed = False, True

    def count(self, batch) -> dict:
        n = batch.num_nodes.numpy().astype(np.int64)
        valid = batch.sample_mask.numpy() if batch.sample_mask is not None else np.ones(len(n), bool)
        n = n[valid]
        out = {"B": int(batch.node_ids.shape[0]), "N": int(batch.node_ids.shape[1]), "valid": int(valid.sum()),
               "nodes": int(n.sum()), "edges": int(batch.adj.numpy()[valid].sum()),
               "adj_bytes": int((n * ((n + 7) // 8)).sum())}
        if self.last is not None:
            self.step += 1
            ids = np.concatenate([batch.node_ids.numpy().ravel(), batch.targets.numpy(),
                                  batch.negatives.numpy().ravel()]).astype(np.int64)
            uid = np.unique(ids)
            uid = uid[uid != 0]
            before = self.last[uid]
            terms = np.where(before > 0, np.minimum(self.step - 1 - before, TAIL_TERMS), 0)
            self.last[uid] = self.step
            out.update(rows=int(len(uid)), row_terms=int(terms.sum()), unique_slots=int(len(ids)))
        return out
