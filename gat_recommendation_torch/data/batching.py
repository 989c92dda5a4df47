"""Bucketed fixed-shape session graphs: CSR graph, induced subgraphs, SessionBatch.

The host side is numpy, as in the JAX package's ``data/batching.py``: the
co-occurrence graph is pre-indexed as CSR adjacency, and each session's
induced subgraph becomes a dense boolean adjacency ``adj[b, dst, src]`` over
the bucket's node slots. ``SessionBatch`` holds the torch tensors one forward
pass reads, plus the targets, negatives and sample mask when training.
``SessionDataset`` pre-indexes the sessions (numpy and ``data/csv_io.py``),
``iterate_batches`` yields one epoch of host batches (the C++ engine of
``data/native.py`` where it builds, else the numpy engine), and
``make_grad_index`` builds the duplicate-row index of the sparse train step on
the host. ``chain_iterator`` groups consecutive batches of one node bucket,
and ``stack_batches`` / ``stack_grad_indices`` stack a group into the [C, ...]
payload of a chained train or eval step. ``to_device`` copies a batch and its
index to the card from pinned memory without blocking, and
``prefetch_to_device`` runs such transfers ahead of the consumer on a
background thread and, on the card, a side stream. Towards any device but
the CPU, ``to_device`` bit-packs the adjacency first (``pack_adj``: 8x fewer
bytes on the batch's largest tensor), as the JAX package does; the models
read the packed rows through ``SessionBatch.dense_adj`` or, the Graph
Transformer's attention kernel, as they are. CPU batches stay bool.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import queue
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from gat_recommendation_torch.data.csv_io import read_csv
from gat_recommendation_torch.device import capture_lock, resolve_device
from gat_recommendation_torch.ops.masked import unpack_adjacency
from gat_recommendation_torch.utils import tracing

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
    """One fixed-shape batch of padded session graphs.

    node_ids    [B, N] int32 — global item ids, ascending per session, 0-padded
    node_mask   [B, N] bool  — valid node slots
    adj         [B, N, N] bool — adj[b, dst, src] = edge src->dst (local ids),
                or bit-packed [B, N, ceil(N/8)] uint8 on the way to a device
                (``pack_adj``; ``adj_packed`` tells which, ``dense_adj()``
                gives the bool form either way)
    num_nodes   [B] int32    — valid node count per session
    targets     [B] int32    — next-item label (last session event)
    negatives   [B, K] int32 — sampled negative item ids
    sample_mask [B] bool     — valid samples (False = batch padding slot)

    The last three are None when serving.
    """

    node_ids: torch.Tensor
    node_mask: torch.Tensor
    adj: torch.Tensor
    num_nodes: torch.Tensor
    targets: torch.Tensor | None = None
    negatives: torch.Tensor | None = None
    sample_mask: torch.Tensor | None = None

    @property
    def batch_size(self) -> int:
        return int(self.node_ids.shape[0])

    @property
    def nodes_per_session(self) -> int:
        return int(self.node_ids.shape[1])

    @property
    def adj_packed(self) -> bool:
        """Whether `adj` holds the bit-packed rows: uint8 of width ceil(N / 8)
        (a dense adjacency in a batch is bool)."""
        n = self.adj.shape[-2]
        return self.adj.dtype == torch.uint8 and self.adj.shape[-1] == (n + 7) // 8

    def dense_adj(self) -> torch.Tensor:
        """The bool [..., N, N] adjacency, unpacked on the adjacency's device
        where it is bit-packed (plain PyTorch, as XLA unpacks it in the JAX
        package)."""
        if not self.adj_packed:
            return self.adj
        return unpack_adjacency(self.adj, self.adj.shape[-2])

    def map(self, fn) -> "SessionBatch":
        """A batch of `fn(tensor)` for every field that is set."""
        fields = (getattr(self, f.name) for f in dataclasses.fields(self))
        return SessionBatch(*(None if t is None else fn(t) for t in fields))

    def to(self, device) -> "SessionBatch":
        return self.map(lambda t: t.to(device))


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


def sample_negatives(rng: np.random.Generator, exclude, num_items: int, k: int) -> np.ndarray:
    """k negatives from [1, num_items) excluding `exclude` (rejection sampling;
    duplicates among negatives allowed).

    Termination guard: when the candidate range is empty (num_items <= 1) or
    the session covers nearly the whole catalog (tiny test datasets),
    rejection sampling cannot terminate; after a bounded number of rounds
    in-session negatives are allowed rather than looping forever."""
    out = np.empty(k, dtype=np.int32)
    if num_items <= 1:
        out[:] = 0  # no valid candidate range; padding id (masked downstream)
        return out
    got = 0
    for _ in range(64):  # bounded rounds; ~certain success unless exclude ≈ catalog
        cands = rng.integers(1, num_items, size=max(2 * (k - got), 8))
        for c in cands:
            if int(c) not in exclude:
                out[got] = c
                got += 1
                if got == k:
                    return out
    # Degenerate catalog: permit in-session negatives.
    out[got:] = rng.integers(1, num_items, size=k - got)
    return out


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


def _read_sessions_csv(path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(session_id, timestamp, itemid) columns of a CSV with those headers,
    with the dtypes pandas would read (``data/csv_io.py``): integer ids and
    timestamps int64, other session ids strings. Raises if an itemid is
    empty or not an integer."""
    cols = read_csv(path, usecols=("session_id", "timestamp", "itemid"))
    if cols["itemid"].dtype.kind != "i":
        raise ValueError(f"{path}: itemid must be integers, read as {cols['itemid'].dtype}")
    return cols["session_id"], cols["timestamp"], cols["itemid"].astype(np.int64)


class SessionDataset:
    """Pre-indexed sessions plus the CSR graph.

    sessions: a CSV path with columns session_id/timestamp/itemid, or the
    three columns as arrays: a ``(session_id, timestamp, itemid)`` tuple or a
    mapping with those keys (no DataFrame needed).
    edges: (item_i, item_j) arrays (from ``data.graph.load_edges``).
    Sessions are ordered by sorted session_id; each is time-sorted (a stable
    sort, so events with equal timestamps keep their order) and truncated to
    the LAST max_session_length events.
    """

    def __init__(
        self,
        sessions,
        edges: tuple,
        num_negatives: int = 5,
        max_session_length: int = 50,
        num_items: int | None = None,
    ):
        if isinstance(sessions, (str, Path)):
            sid, ts, item = _read_sessions_csv(sessions)
        elif isinstance(sessions, tuple):
            sid, ts, item = (np.asarray(a) for a in sessions)
        else:
            sid, ts, item = (np.asarray(sessions[k]) for k in ("session_id", "timestamp", "itemid"))
        self.num_negatives = num_negatives
        self.max_session_length = max_session_length

        # Sorted unique session ids and each event's session code; then a stable
        # sort by (session, timestamp).
        self.session_ids, codes = np.unique(sid, return_inverse=True)
        order = np.lexsort((ts, codes))
        codes = codes[order]
        items_all = item[order].astype(np.int64)
        counts = np.bincount(codes, minlength=len(self.session_ids))
        ends_all = np.cumsum(counts)
        starts_all = ends_all - counts

        # Truncate to the last max_session_length events (vectorized).
        keep_len = np.minimum(counts, max_session_length)
        pos = np.arange(len(items_all)) - starts_all[codes]
        keep = pos >= (counts - keep_len)[codes]
        self.items = items_all[keep]
        self.offsets = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(keep_len, out=self.offsets[1:])

        item_i, item_j = edges
        item_i = np.asarray(item_i, dtype=np.int64)
        item_j = np.asarray(item_j, dtype=np.int64)
        if num_items is None:
            # Raw max id + 1 across sessions and edges, NOT the count of
            # connected nodes.
            num_items = int(
                max(items_all.max(initial=0), item_i.max(initial=0), item_j.max(initial=0))
            ) + 1
        self.num_items = num_items
        self.graph = build_csr(item_i, item_j, num_items)

        # Per-session unique-context-node counts (bucket assignment),
        # vectorized: lexsort (session, item) then count segment-uniques.
        ctx_sess = np.repeat(np.arange(len(counts)), np.maximum(keep_len - 1, 0))
        last_of = self.offsets[1:] - 1
        ctx_mask = np.ones(len(self.items), dtype=bool)
        ctx_mask[last_of[keep_len > 0]] = False
        ctx_items = self.items[ctx_mask]
        if len(ctx_items):
            order = np.lexsort((ctx_items, ctx_sess))
            s, it = ctx_sess[order], ctx_items[order]
            new = np.ones(len(s), dtype=bool)
            new[1:] = (s[1:] != s[:-1]) | (it[1:] != it[:-1])
            self.unique_counts = np.bincount(s[new], minlength=len(counts)).astype(np.int32)
        else:
            self.unique_counts = np.zeros(len(counts), dtype=np.int32)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def session_items(self, idx: int) -> np.ndarray:
        """Time-ordered (truncated) item ids of session `idx`."""
        return self.items[self.offsets[idx] : self.offsets[idx + 1]]

    def sample(self, idx: int, rng: np.random.Generator) -> dict:
        """One training sample: sorted-unique context nodes, induced local
        edges, last event as target, rejection-sampled negatives."""
        items = self.session_items(idx)
        target = int(items[-1])
        nodes = np.unique(items[:-1])
        src, dst = induced_edges(self.graph, nodes)
        negatives = sample_negatives(rng, set(items.tolist()), self.num_items, self.num_negatives)
        return {
            "nodes": nodes.astype(np.int32),
            "edge_src": src,
            "edge_dst": dst,
            "target": target,
            "negatives": negatives,
        }


# ---------------------------------------------------------------------------
# Collate + epoch iteration
# ---------------------------------------------------------------------------


def collate(samples: list, bucket_n: int, num_negatives: int) -> SessionBatch:
    """Assemble fixed-shape host tensors from per-session samples (None =
    padding slot). Nodes beyond bucket_n are truncated with their edges
    dropped (never triggered at max_session_length=50 with the default
    buckets). The tensors share memory with the numpy arrays built here."""
    B = len(samples)
    node_ids = np.zeros((B, bucket_n), dtype=np.int32)
    node_mask = np.zeros((B, bucket_n), dtype=bool)
    adj = np.zeros((B, bucket_n, bucket_n), dtype=bool)
    num_nodes = np.zeros(B, dtype=np.int32)
    targets = np.zeros(B, dtype=np.int32)
    negatives = np.zeros((B, num_negatives), dtype=np.int32)
    sample_mask = np.zeros(B, dtype=bool)

    for b, s in enumerate(samples):
        if s is None:
            continue
        nodes = np.asarray(s["nodes"])[:bucket_n]
        n = len(nodes)
        node_ids[b, :n] = nodes
        node_mask[b, :n] = True
        num_nodes[b] = n
        src = np.asarray(s["edge_src"])
        dst = np.asarray(s["edge_dst"])
        if len(src):
            ok = (src < n) & (dst < n)
            adj[b, dst[ok], src[ok]] = True
        targets[b] = s["target"]
        negatives[b] = np.asarray(s["negatives"])[:num_negatives]
        sample_mask[b] = True

    return SessionBatch(
        *(
            torch.from_numpy(a)
            for a in (node_ids, node_mask, adj, num_nodes, targets, negatives, sample_mask)
        )
    )


# Sentinel for unused uid slots: out of range of any table, so the sparse
# AdamW update never finds a row for it.
UID_SENTINEL = np.int32(2**31 - 1)

# The unique-row count is bucketed so that the summed-gradient buffer takes
# few distinct shapes per (batch shape, bucket) pair.
UNIQUE_BUCKETS = (1024, 2048, 4096, 8192, 16384, 32768, 65536)


class GradIndex(NamedTuple):
    """Host-precomputed index for sparse embedding gradients.

    The sparse train step differentiates with respect to the gathered
    embedding rows only; turning those row gradients into per-unique-id sums
    needs a sort, done here on the host where the ids already sit in the
    batch. Fields (R = B*(N+1+K), U = unique-count bucket):

    ids     [R] int32 — concat(node_ids.flat, targets, negatives.flat)
    perm    [R] int32 — stable argsort of ids
    seg     [R] int32 — segment number of each sorted slot (equal ids share one)
    uid     [U] int32 — ascending unique ids, UID_SENTINEL-padded tail (U >= uniques)
    lengths [U] int64 — slots per segment (0 for the sentinel tail); the
            deterministic sorted segment sum of the train step reads it
    """

    ids: np.ndarray
    perm: np.ndarray
    seg: np.ndarray
    uid: np.ndarray
    lengths: np.ndarray


def make_grad_index(batch: SessionBatch) -> GradIndex:
    """Build the sparse-gradient index on the host (numpy) from a host batch."""
    ids = np.concatenate(
        [
            np.asarray(batch.node_ids).reshape(-1),
            np.asarray(batch.targets),
            np.asarray(batch.negatives).reshape(-1),
        ]
    ).astype(np.int32)
    return make_grad_index_from_ids(ids)


def make_grad_index_from_ids(ids: np.ndarray) -> GradIndex:
    """GradIndex from a raw id list."""
    ids = np.asarray(ids, dtype=np.int32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    sid = ids[perm]
    is_new = np.ones(len(sid), dtype=bool)
    is_new[1:] = sid[1:] != sid[:-1]
    seg = (np.cumsum(is_new) - 1).astype(np.int32)
    num_unique = int(seg[-1]) + 1 if len(seg) else 0
    U = next((b for b in UNIQUE_BUCKETS if num_unique <= b), len(ids))
    U = min(U, len(ids)) if len(ids) else 1
    uid = np.full(U, UID_SENTINEL, np.int32)
    uid[seg] = sid  # ascending uniques (sid is sorted), sentinel tail
    lengths = np.bincount(seg, minlength=U).astype(np.int64)
    return GradIndex(ids=ids, perm=perm, seg=seg, uid=uid, lengths=lengths)


def stack_batches(batches: list) -> SessionBatch:
    """Stack C same-shape host batches into one [C, ...] batch, the payload
    of a chained train or eval step (one transfer covers C steps)."""
    names = [f.name for f in dataclasses.fields(SessionBatch)]
    return SessionBatch(*(
        None if getattr(batches[0], n) is None else torch.stack([getattr(b, n) for b in batches])
        for n in names
    ))


def stack_grad_indices(gidxs: list) -> GradIndex:
    """Stack C GradIndexes to [C, ...], padding every uid to the group's
    largest unique-count bucket with ``UID_SENTINEL`` and its lengths with 0:
    the sorted segment sum gives zero rows there, and the sparse update drops
    sentinel slots."""
    U = max(g.uid.shape[0] for g in gidxs)

    def pad(a: np.ndarray, fill) -> np.ndarray:
        out = np.full(U, fill, a.dtype)
        out[: len(a)] = a
        return out

    return GradIndex(
        ids=np.stack([g.ids for g in gidxs]),
        perm=np.stack([g.perm for g in gidxs]),
        seg=np.stack([g.seg for g in gidxs]),
        uid=np.stack([pad(g.uid, UID_SENTINEL) for g in gidxs]),
        lengths=np.stack([pad(g.lengths, 0) for g in gidxs]),
    )


def chain_iterator(iterator, chain: int):
    """Group consecutive epoch items into runs of `chain` with equal node
    bucket (``iterate_batches`` yields buckets in ascending order, so runs are
    long). Yields lists of items; a partial run at a bucket boundary or at
    the epoch's end is yielded as it is (the Trainer splits it into shorter
    chains and single steps)."""
    pending: list = []
    pending_n = None
    for item in iterator:
        batch = item[0] if isinstance(item, tuple) else item
        n = batch.nodes_per_session
        if pending and n != pending_n:
            yield pending
            pending = []
        pending.append(item)
        pending_n = n
        if len(pending) == chain:
            yield pending
            pending = []
    if pending:
        yield pending


def pack_adj(batch: SessionBatch) -> SessionBatch:
    """The host batch with its bool adjacency bit-packed along the last axis,
    [..., N, ceil(N / 8)] uint8, most significant bit first (source j is bit
    7 - j % 8 of byte j // 8: ``np.packbits(adj, axis=-1)``); a packed batch
    as it is. Packs in the C++ library (``data/native.py``) where it builds:
    its call releases the interpreter lock, so that a pipeline thread packing
    one batch does not hold up the thread that launches the steps. Else
    ``np.packbits``, the plain version; both give the same bytes."""
    if batch.adj_packed:
        return batch
    from gat_recommendation_torch.data import native

    adj = batch.adj.numpy()
    packed = native.pack_bits(adj) if native.available() else np.packbits(adj, axis=-1)
    return dataclasses.replace(batch, adj=torch.from_numpy(packed))


def worth_packing(device) -> bool:
    """Packing pays where a copy to a device exists: towards the CPU the
    'transfer' is a copy in memory, and every step would pay the unpack for
    nothing (the JAX package's ``_worth_packing``)."""
    return torch.device(device).type != "cpu"


def _packed(item):
    if isinstance(item, SessionBatch):
        return pack_adj(item)
    if isinstance(item, tuple) and not isinstance(item, GradIndex):
        return tuple(_packed(part) for part in item)
    return item


def to_device(item, device):
    """Copy a host ``SessionBatch``, a ``GradIndex`` (numpy fields) or a tuple
    of them to `device`; a batch's adjacency goes bit-packed to any device
    but the CPU (``worth_packing``, ``pack_adj``). Towards a CUDA device each
    host tensor is copied into a pinned block of the caching host allocator
    (which reuses a block once the copy out of it has finished) and the
    copies do not block the host (``non_blocking=True``); they are ordered on
    the current stream before any kernel that reads them. The CUDA calls hold
    ``capture_lock``, so that a transfer on another thread waits while a CUDA
    graph is being captured."""
    device = torch.device(device)
    if worth_packing(device):
        item = _packed(item)
    if device.type != "cuda":
        return _copy_to(item, lambda t: t.to(device))
    with capture_lock:
        return _copy_to(item, lambda t: (t.pin_memory() if t.device.type == "cpu" else t).to(device, non_blocking=True))


def _copy_to(item, move):
    if isinstance(item, GradIndex):
        return GradIndex(*(move(torch.from_numpy(np.ascontiguousarray(a))) for a in item))
    if isinstance(item, SessionBatch):
        return item.map(move)
    if isinstance(item, tuple):
        return tuple(_copy_to(part, move) for part in item)
    raise TypeError(f"to_device takes a SessionBatch, a GradIndex or a tuple of them, got {type(item)}")


def _tensors(item):
    """Every tensor in a (nested) list or tuple of SessionBatches, GradIndexes
    and tensors; other leaves (the "chained" tag) hold none."""
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, SessionBatch):
        yield from (getattr(item, f.name) for f in dataclasses.fields(item) if getattr(item, f.name) is not None)
    elif isinstance(item, (tuple, list)):  # GradIndex is a tuple
        for part in item:
            yield from _tensors(part)


def prefetch_to_device(iterator, size: int = 2, transfer=None, transfer_workers: int = 1, device=None):
    """Iterate `iterator`, transferring up to `size` items ahead on a
    background thread, so that host batch assembly and the host-to-device
    copies overlap the device's work. `transfer(item)` returns the item on
    `device` (default ``to_device(item, device)``; `device` is ``cuda`` when
    None, which raises without a CUDA device).

    ``transfer_workers > 1`` runs the transfers on a thread pool behind a
    queue of futures that keeps the iterator's order. An error in the
    iterator or in a transfer is raised in the consumer. A consumer that
    abandons the generator (break, exception, garbage collection) sets a
    `stop` event that releases the background thread.

    On the card every transfer runs on a side stream, and an event recorded
    after it orders the consumer's current stream behind the copies before
    the item is yielded. Each tensor of a yielded item is marked as used by
    the consumer's stream (``record_stream``), so the caching allocator does
    not hand its memory to a later transfer while the consumer's kernels
    still read it.

    Spans (``utils/tracing.py``): each transfer is a ``transfer`` and each
    wait of the consumer for its next item (and for the end) a ``wait``,
    both with the item's position as ``batch``.
    """
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card and device.index is None:  # the worker threads need the index itself
        device = torch.device("cuda", torch.cuda.current_device())
    move = transfer if transfer is not None else (lambda item: to_device(item, device))
    side = torch.cuda.Stream(device) if on_card else None

    def staged(i, item):
        with tracing.span(tracing.TRANSFER, batch=i):
            if not on_card:
                return move(item), None
            with torch.cuda.stream(side):
                out = move(item)
                with capture_lock:
                    done = torch.cuda.Event()
                    done.record(side)
            return out, done

    def bind_device():
        if on_card:
            with capture_lock:
                torch.cuda.set_device(device)

    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    error: list[BaseException] = []
    stop = threading.Event()
    pool = (concurrent.futures.ThreadPoolExecutor(max_workers=transfer_workers, initializer=bind_device)
            if transfer_workers > 1 else None)

    def worker():
        try:
            bind_device()
            for i, item in enumerate(iterator):
                # Pool mode: the future is queued; a transfer's error surfaces
                # at .result() in the consumer.
                payload = pool.submit(staged, i, item) if pool else staged(i, item)
                while not stop.is_set():
                    try:
                        q.put(payload, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # raised again in the consumer's thread
            error.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    return
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for i in itertools.count():
            with tracing.span(tracing.WAIT, batch=i):
                payload = q.get()
                if payload is not sentinel:
                    out, done = payload.result() if pool else payload
                    if on_card:
                        current = torch.cuda.current_stream(device)
                        current.wait_event(done)
                        for tensor in _tensors(out):
                            tensor.record_stream(current)
            if payload is sentinel:
                if error:
                    raise error[0]
                return
            yield out
    finally:
        # Reached on close() or garbage collection of a part-consumed
        # generator: release the worker and drop the queued device items.
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        if pool:
            pool.shutdown(wait=False, cancel_futures=True)


def _slot_rng(seed: int, batch_index: int, gslot: int) -> np.random.Generator:
    """Negatives are keyed by (seed, batch_index, slot): a PCG substream per
    slot, so a batch's content never depends on the order of assembly."""
    return np.random.default_rng([seed, batch_index, gslot])


def _native_batch_seed(seed: int, batch_index: int) -> int:
    """The C++ engine's seed of batch `batch_index`; the engine derives each
    slot's SplitMix64 stream from it and the slot's global index."""
    return int((np.uint64(seed) << np.uint64(20)) + np.uint64(batch_index))


def _splitmix64(state: np.uint64) -> tuple[np.uint64, np.uint64]:
    """One SplitMix64 draw (a numpy copy of the C++ engine's, native/batcher.cpp)."""
    with np.errstate(over="ignore"):
        state = state + np.uint64(0x9E3779B97F4A7C15)
        z = state
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return state, z ^ (z >> np.uint64(31))


def _native_negatives(batch_seed: int, gslot: int, session_items, num_items: int, k: int) -> np.ndarray:
    """The C++ engine's negatives of GLOBAL slot `gslot` (its stream starts at
    seed ^ golden * (gslot + 1)), for a process that does not assemble that slot."""
    out = np.zeros(k, dtype=np.int32)
    if num_items <= 1:
        return out
    uniq = set(int(x) for x in session_items)
    with np.errstate(over="ignore"):
        state = np.uint64(batch_seed) ^ (np.uint64(0x9E3779B97F4A7C15) * np.uint64(gslot + 1))
    got, attempts, max_attempts = 0, 0, 128 * k
    while got < k and attempts < max_attempts:
        attempts += 1
        state, z = _splitmix64(state)
        cand = 1 + int(z % np.uint64(num_items - 1))
        if cand in uniq:
            continue
        out[got] = cand
        got += 1
    while got < k:  # a catalog too small to avoid the session's items (as the engine does)
        state, z = _splitmix64(state)
        out[got] = 1 + int(z % np.uint64(num_items - 1))
        got += 1
    return out


class GlobalBatchMeta(NamedTuple):
    """What every process knows of a GLOBAL batch without assembling the other
    processes' rows (no adjacency): the targets and the sample mask for the
    metrics, and with ``ids`` the id list of the replicated GradIndex.

    targets     [B_global] int32
    sample_mask [B_global] bool
    ids         [R_global] int32 or None: concat(node_ids.flat, targets,
                negatives.flat) of the global batch (None unless asked for)
    """

    targets: np.ndarray
    sample_mask: np.ndarray
    ids: np.ndarray | None


def _global_batch_meta(dataset: "SessionDataset", chunk: list, batch_size: int, bucket_n: int, seed: int,
                       batch_index: int, engine: str, with_ids: bool) -> GlobalBatchMeta:
    """The global batch's meta, from the sessions alone (no CSR or adjacency work)."""
    K = dataset.num_negatives
    targets = np.zeros(batch_size, dtype=np.int32)
    sample_mask = np.zeros(batch_size, dtype=bool)
    if with_ids:
        node_ids = np.zeros((batch_size, bucket_n), dtype=np.int32)
        negatives = np.zeros((batch_size, K), dtype=np.int32)
    for g, idx in enumerate(chunk):
        items = dataset.session_items(idx)
        targets[g] = items[-1]
        sample_mask[g] = True
        if with_ids:
            nodes = np.unique(items[:-1])[:bucket_n]
            node_ids[g, : len(nodes)] = nodes
            if engine == "native":
                negatives[g] = _native_negatives(_native_batch_seed(seed, batch_index), g, items,
                                                 dataset.num_items, K)
            else:
                negatives[g] = sample_negatives(_slot_rng(seed, batch_index, g), set(items.tolist()),
                                                dataset.num_items, K)
    ids = None
    if with_ids:
        ids = np.concatenate([node_ids.reshape(-1), targets, negatives.reshape(-1)]).astype(np.int32)
    return GlobalBatchMeta(targets=targets, sample_mask=sample_mask, ids=ids)


def _resolve_engine(engine: str) -> str:
    """"auto" is the C++ engine where it builds (``native.available()``),
    else the numpy engine."""
    if engine == "auto":
        from gat_recommendation_torch.data import native

        return "native" if native.available() else "numpy"
    if engine not in ("numpy", "native"):
        raise ValueError(f"Unknown batching engine: {engine}")
    return engine


def iterate_batches(
    dataset: SessionDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    engine: str = "auto",
    buckets=DEFAULT_BUCKETS,
    workers: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    with_global_meta: bool = False,
    with_global_ids: bool = False,
):
    """Yield host SessionBatches covering one epoch.

    Sessions are grouped by node-count bucket (ascending bucket order, each
    bucket's sessions in epoch-shuffled order); every batch has exactly
    `batch_size` slots, remainders padded with masked samples. ``engine``:
    "native" (the C++ engine, ``data/native.py``), "numpy", or "auto" (the
    C++ engine where it builds). Both engines give the same grouping, nodes,
    adjacency and targets; their negatives come from different streams
    (SplitMix64 against PCG). Every batch's content is a pure function of
    (seed, batch_index, slot).

    ``workers > 0`` assembles the batches on a thread pool, at most
    ``2 * workers`` in flight, and yields them in order: the same epoch as
    ``workers=0``. The C++ engine releases the interpreter lock while it
    assembles a batch, so its batches are built in parallel. Each batch's
    assembly is an ``assemble`` span (``utils/tracing.py``), its position in
    the schedule its ``batch``.

    Several processes (the data ranks of a mesh): `batch_size` is the GLOBAL
    batch size. The schedule is a pure function of (dataset, seed), so every
    process computes the same one, and process `process_index` of
    `process_count` assembles rows ``[p * local, (p + 1) * local)`` of each
    global batch (local = batch_size / process_count). Both engines key the
    negatives by global slot, so the processes' local batches put together
    equal the one-process batch. With `with_global_meta` (implied by
    `process_count` > 1 or `with_global_ids`) each item is a pair
    (local batch, ``GlobalBatchMeta``); `with_global_ids` fills the meta's
    ``ids`` for the replicated GradIndex of the sharded sparse step.
    """
    engine = _resolve_engine(engine)
    if batch_size % process_count:
        raise ValueError(f"global batch size {batch_size} must divide by process count {process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(f"process index {process_index} of {process_count}")
    local = batch_size // process_count
    with_global_meta = with_global_meta or process_count > 1 or with_global_ids
    if engine == "native":
        from gat_recommendation_torch.data import native
    # Invariant: a session truncated to max_session_length events has at most
    # max_session_length - 1 unique context nodes; the largest bucket must
    # hold them or `collate` would silently drop nodes (and their edges).
    need = max(int(dataset.max_session_length) - 1, 1)
    if buckets[-1] < need:
        buckets = tuple(buckets) + (-(-need // 8) * 8,)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))

    by_bucket: dict[int, list[int]] = {b: [] for b in buckets}
    for i in order:
        by_bucket[pick_bucket(int(dataset.unique_counts[i]), buckets)].append(int(i))

    schedule = []
    for bucket_n in buckets:
        idxs = by_bucket[bucket_n]
        for lo in range(0, len(idxs), batch_size):
            schedule.append((idxs[lo : lo + batch_size], bucket_n, len(schedule)))

    def build(item):
        chunk, bucket_n, batch_index = item
        with tracing.span(tracing.ASSEMBLE, batch=batch_index):
            lo = process_index * local
            mine = chunk[lo:lo + local]
            if engine == "native":
                batch = native.assemble_batch(dataset, mine, local, bucket_n,
                                              _native_batch_seed(seed, batch_index), slot_offset=lo)
            else:
                samples = [dataset.sample(i, _slot_rng(seed, batch_index, lo + s)) for s, i in enumerate(mine)]
                samples += [None] * (local - len(mine))
                batch = collate(samples, bucket_n, dataset.num_negatives)
            if not with_global_meta:
                return batch
            return batch, _global_batch_meta(dataset, chunk, batch_size, bucket_n, seed, batch_index, engine,
                                             with_global_ids)

    if workers <= 0:
        for item in schedule:
            yield build(item)
        return

    # A bounded window of batches in flight (an unbounded map would hold the
    # whole epoch in memory), yielded in schedule order.
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        inflight: collections.deque = collections.deque()
        try:
            for item in schedule:
                inflight.append(ex.submit(build, item))
                if len(inflight) >= 2 * workers:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        finally:
            for f in inflight:
                f.cancel()
