"""Synthetic RetailRocket-like event generators, without pandas.

The same two generators as the JAX package's ``data/synthetic.py``, with the
same draws in the same order from ``np.random.default_rng(seed)``, so that a
seed gives the same events column for column. Each returns the columns
``timestamp`` (int64 ms), ``visitorid`` and ``event`` (strings), ``itemid``
(int64) and ``transactionid`` (an object array: NaN except on transactions,
where it holds an int), as a dict in that order (``data/csv_io.py`` writes
it as the pipeline's raw events file).

* ``generate_synthetic_events``: Zipf item popularity over a permuted
  catalog, exponential gaps, a view / addtocart / transaction state machine;
  every event an independent popularity draw.
* ``generate_structured_events``: sessions are random walks on a hidden
  clustered Markov item graph with popularity-noise distractors and revisits
  (the discriminative corpus of the reference-scale study).

Timestamps are globally monotonic; gaps inside a session stay below 30 min
and gaps between sessions above it.
"""

from __future__ import annotations

import numpy as np

COLUMNS = ("timestamp", "visitorid", "event", "itemid", "transactionid")


def _columns(ts, visitors, events, items, tx) -> dict:
    return dict(zip(COLUMNS, (ts, np.char.add("visitor_", visitors.astype(np.str_)), events, items, tx)))


def generate_synthetic_events(
    num_sessions: int = 2000,
    num_items: int = 1000,
    seed: int = 42,
    start_ts: int = 1_430_000_000_000,
    mean_session_length: int = 8,
    zipf_exponent: float = 1.5,
) -> dict:
    """Independent Zipf(`zipf_exponent`) draws over a permuted catalog (1.5:
    the reference parity; about 1.2 gives a RetailRocket-shaped graph at
    466k items)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_items + 1, dtype=np.float64)
    probs = ranks**-zipf_exponent
    cumprobs = np.cumsum(probs / probs.sum())
    perm = rng.permutation(num_items)

    num_visitors = max(1, num_sessions // 2)
    lengths = 2 + rng.poisson(mean_session_length - 2, size=num_sessions)
    total = int(lengths.sum())
    visitors = rng.integers(0, num_visitors, size=num_sessions)
    view_pool = perm[np.minimum(np.searchsorted(cumprobs, rng.random(total)), num_items - 1)]
    rolls = rng.random(total)
    tx_ids = rng.integers(10_000, 99_999, size=total)
    intra_gaps = np.minimum(rng.exponential(5 * 60_000, size=total), 29 * 60_000 - 1).astype(np.int64)
    inter_gaps = (35 * 60_000 + rng.exponential(90 * 60_000, size=num_sessions)).astype(np.int64)

    ts_col = np.empty(total, dtype=np.int64)
    visitor_col = np.empty(total, dtype=np.int64)
    event_col = np.empty(total, dtype=object)
    item_col = np.empty(total, dtype=np.int64)
    tx_col = np.full(total, np.nan, dtype=object)

    # The per-event state machine over the pre-drawn streams.
    e = 0
    t = int(start_ts)
    for s in range(num_sessions):
        last_view = -1
        cart: list[int] = []
        for _ in range(int(lengths[s])):
            r = rolls[e]
            if last_view >= 0 and r < 0.12:
                event, item = "addtocart", last_view
                cart.append(item)
            elif cart and r < 0.17:
                event, item = "transaction", cart.pop()
                tx_col[e] = int(tx_ids[e])
            else:
                event = "view"
                item = int(view_pool[e])
                last_view = item
            ts_col[e] = t
            visitor_col[e] = visitors[s]
            event_col[e] = event
            item_col[e] = item
            t += int(intra_gaps[e])
            e += 1
        t += int(inter_gaps[s])

    return _columns(ts_col, visitor_col, event_col.astype(str), item_col, tx_col)


def generate_structured_events(
    num_sessions: int = 20_000,
    num_items: int = 5_000,
    seed: int = 42,
    num_active: int | None = None,
    num_clusters: int | None = None,
    successors_per_item: int = 8,
    cross_cluster_successors: int = 2,
    dirichlet_alpha: float = 0.4,
    noise_prob: float = 0.15,
    repeat_prob: float = 0.25,
    pop_exponent: float = 1.05,
    mean_session_length: int = 8,
    start_ts: int = 1_430_000_000_000,
) -> dict:
    """Sessions as random walks on a hidden item-transition graph: only
    `num_active` ids occur, in `num_clusters` clusters; each active item has
    `successors_per_item` successors (`cross_cluster_successors` of them in
    two linked clusters) with Dirichlet(`dirichlet_alpha`) weights; a walk
    starts from a near-flat Zipf(`pop_exponent`) draw, a step is a
    popularity distractor with probability `noise_prob` (never the final
    event) or revisits an earlier walk item with `repeat_prob`."""
    rng = np.random.default_rng(seed)
    if num_active is None:
        num_active = max(min(num_items - 1, 50), num_items // 6)
    if num_clusters is None:
        num_clusters = max(2, num_active // 100)
    k_total = successors_per_item
    k_cross = min(cross_cluster_successors, k_total - 1)

    # Latent structure: active ids (never 0, the padding row) in clusters.
    active = rng.choice(np.arange(1, num_items, dtype=np.int64), size=num_active, replace=False)
    order = rng.permutation(num_active)
    bounds = np.linspace(0, num_active, num_clusters + 1).astype(np.int64)
    members = [order[bounds[c] : bounds[c + 1]] for c in range(num_clusters)]

    # Successor table [num_active, K]: in-cluster draws (self skipped), then
    # k_cross draws into the linked clusters (ring + skip).
    succ = np.empty((num_active, k_total), dtype=np.int64)
    link_a = np.arange(num_clusters)
    link_b = (link_a + 1) % num_clusters
    link_c = (link_a + max(2, num_clusters // 3)) % num_clusters
    for c in range(num_clusters):
        mem = members[c]
        n_mem = len(mem)
        k_in = k_total - k_cross
        pick = rng.integers(0, max(n_mem - 1, 1), size=(n_mem, k_in))
        own = np.arange(n_mem)[:, None]
        pick = pick + (pick >= own)
        succ[mem, :k_in] = mem[np.minimum(pick, n_mem - 1)]
        for j in range(k_cross):
            tgt = members[int((link_b if j % 2 == 0 else link_c)[c])]
            succ[mem, k_in + j] = tgt[rng.integers(0, len(tgt), size=n_mem)]

    gam = rng.gamma(dirichlet_alpha, size=(num_active, k_total))
    cum_tr = np.cumsum(gam / gam.sum(axis=1, keepdims=True), axis=1)

    ranks = np.arange(1, num_active + 1, dtype=np.float64)
    pw = ranks**-pop_exponent
    pop_cum = np.cumsum(pw / pw.sum())
    pop_perm = rng.permutation(num_active)

    def draw_pop(n: int) -> np.ndarray:
        return pop_perm[np.minimum(np.searchsorted(pop_cum, rng.random(n)), num_active - 1)]

    # The walks, all sessions in lockstep.
    lengths = np.clip(3 + rng.poisson(max(mean_session_length - 3, 1), size=num_sessions), 3, 50)
    max_len = int(lengths.max())
    state = draw_pop(num_sessions)
    emitted = np.zeros((num_sessions, max_len), dtype=np.int64)
    emitted[:, 0] = state
    walk_hist = np.zeros((num_sessions, max_len), dtype=np.int64)
    walk_hist[:, 0] = state
    walk_count = np.ones(num_sessions, dtype=np.int64)
    for t in range(1, max_len):
        alive = t < lengths
        is_last = t == lengths - 1
        noisy = alive & ~is_last & (rng.random(num_sessions) < noise_prob)
        walk = alive & ~noisy
        rep = walk & (rng.random(num_sessions) < repeat_prob) & (walk_count >= 2)
        r = np.flatnonzero(rep)
        if len(r):
            pick = (rng.random(len(r)) * walk_count[r]).astype(np.int64)
            back = walk_hist[r, pick]
            emitted[r, t] = back
            state[r] = back
        w = np.flatnonzero(walk & ~rep)
        if len(w):
            u = rng.random(len(w))
            choice = (u[:, None] > cum_tr[state[w]]).sum(axis=1)
            nxt = succ[state[w], np.minimum(choice, k_total - 1)]
            emitted[w, t] = nxt
            state[w] = nxt
            walk_hist[w, walk_count[w]] = nxt
            walk_count[w] += 1
        d = np.flatnonzero(noisy)
        if len(d):
            emitted[d, t] = draw_pop(len(d))

    # Flatten to the event schema, session-major (= time order).
    total = int(lengths.sum())
    valid = np.arange(max_len)[None, :] < lengths[:, None]
    item_col = active[emitted[valid]]
    sid = np.repeat(np.arange(num_sessions), lengths)

    # A flat relabel of non-final events: ~8 % addtocart, ~3 % transaction.
    event_col = np.full(total, "view", dtype=object)
    roll = rng.random(total)
    is_final = np.zeros(total, dtype=bool)
    is_final[np.cumsum(lengths) - 1] = True
    event_col[(roll < 0.08) & ~is_final] = "addtocart"
    event_col[(roll > 0.97) & ~is_final] = "transaction"
    tx_col = np.full(total, np.nan, dtype=object)
    tx_mask = event_col == "transaction"
    tx_col[tx_mask] = rng.integers(10_000, 99_999, size=int(tx_mask.sum())).astype(object)

    # gaps[i] is the interval after event i; the > 30 min boundary sits on
    # each session's final event.
    intra = np.minimum(rng.exponential(5 * 60_000, size=total), 29 * 60_000 - 1).astype(np.int64)
    inter = (35 * 60_000 + rng.exponential(90 * 60_000, size=num_sessions)).astype(np.int64)
    gaps = intra.copy()
    final_idx = np.cumsum(lengths) - 1
    gaps[final_idx[:-1]] = inter[:-1]
    ts_col = start_ts + np.concatenate([[0], np.cumsum(gaps)[:-1]])

    visitors = rng.integers(0, max(1, num_sessions // 2), size=num_sessions)
    return _columns(ts_col, visitors[sid], event_col.astype(str), item_col, tx_col)
