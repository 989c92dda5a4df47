"""Full-catalog top-k: score plus chunk-max (phase 1), then selection.

Phase 1 is ``ops/score_chunkmax.py`` (a CUDA kernel on the card). Phase 2
selects in PyTorch: the top-k chunks by their max, re-sorted into ascending
chunk order, then the top-k of the k*32 candidate scores.

The selectors of the JAX package's ``ops/scoring.py``, by
``full_catalog_topk(method=)``: ``two_level_topk`` (exact; chunk 32 through
kernel 2, other chunks in plain PyTorch), ``dense_topk`` (the oracle) and
``approx_topk`` (the top of L candidates; exact here, see its docstring).

Exactness, ties included: the result equals a dense top-k that breaks ties by
the lowest index (``jax.lax.top_k``'s rule). Chunks are contiguous index
ranges and both levels break ties by lowest index. Level 1 (membership): if
a candidate e (value v, global index g, chunk c) is excluded, then k chunks
ranked above c each contain an element with value > v, or value >= v at a
lower index; so at least k elements precede e in (value desc, index asc)
order and the dense top-k excludes e too. Level 2 (ranking): the winning
chunks are sorted by chunk index before the gather, so candidate position
order is global index order, and the lowest-position tie-break equals the
dense one (without that sort, scores [5,0,10,5] with chunk 2 and k 2 give
[2,3] where dense gives [2,0]).

``torch.topk`` promises no tie order, so every selection here is a stable
descending ``torch.sort`` cut to its first k.
"""

from __future__ import annotations

import math

import torch

from gat_recommendation_torch.ops.score_chunkmax import CHUNK, _exclude_rows, masked_scores, score_chunkmax

DEFAULT_CHUNK = CHUNK
DEFAULT_CANDIDATES = 128
# Below this row count the plain two-level selection sorts the whole row.
MIN_ROWS_FOR_TWO_LEVEL = 16_384


def _stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties broken by the lowest index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def select_topk(
    scores: torch.Tensor, maxes: torch.Tensor, k: int, chunk: int = CHUNK
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k from scores [B, V] and their chunk maxes [B, V/chunk].

    Falls back to one stable sort of the whole row when there are fewer
    chunks than k (tiny catalogs). Returns (scores [B, k], indices [B, k]).
    """
    B, NC = maxes.shape
    if NC < k:
        return _stable_topk(scores, k)
    _, top_chunks = _stable_topk(maxes, k)
    # Ascending chunk order => candidate positions ascend in global index.
    top_chunks, _ = torch.sort(top_chunks, dim=1)
    chunked = scores.view(B, NC, chunk)
    cand = torch.gather(chunked, 1, top_chunks[:, :, None].expand(B, k, chunk))
    base = top_chunks[:, :, None] * chunk + torch.arange(chunk, device=scores.device)
    s, pos = _stable_topk(cand.reshape(B, k * chunk), k)
    return s, torch.gather(base.reshape(B, k * chunk), 1, pos)


def two_level_topk_scores(
    scores: torch.Tensor, k: int, chunk: int = CHUNK
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a precomputed [B, V] score matrix (any V).

    Columns are -inf-padded to a chunk multiple: a pad column never outranks
    a finite score and sits at the highest indices, so the lowest-index
    tie-break is unaffected.
    """
    B, V = scores.shape
    pad = (-V) % chunk
    if pad:
        scores = torch.cat([scores, scores.new_full((B, pad), -math.inf)], dim=1)
    maxes = scores.view(B, -1, chunk).amax(dim=-1)
    return select_topk(scores, maxes, k, chunk)


def dense_topk(
    session_embeddings: torch.Tensor,
    item_embeddings: torch.Tensor,
    k: int,
    num_items: int | None = None,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle scorer: one plain matmul, the -inf masks, one stable sort.
    `exclude` is [B, V], or [V] when B == 1."""
    return _stable_topk(masked_scores(session_embeddings, item_embeddings, num_items, exclude), k)


def _score_chunkmax_any_rows(
    session_embeddings: torch.Tensor,
    item_embeddings: torch.Tensor,
    num_items: int | None,
    exclude: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2 (``score_chunkmax``) at any row count. A table off the 32-row
    chunk is copied with zero rows appended; the kernel masks them to -inf as
    phantom columns, at the highest indices, so no real column is outranked
    and the lowest-index tie-break is unchanged."""
    B, V = session_embeddings.shape[0], item_embeddings.shape[0]
    pad = (-V) % CHUNK
    if pad:
        item_embeddings = torch.cat([item_embeddings, item_embeddings.new_zeros((pad, item_embeddings.shape[1]))])
        num_items = V if num_items is None else min(num_items, V)
        if exclude is not None:
            exclude = _exclude_rows(exclude, B, V)
            exclude = torch.cat([exclude, exclude.new_zeros((B, pad))], dim=1)
    return score_chunkmax(session_embeddings, item_embeddings, num_items, exclude)


def two_level_topk(
    session_embeddings: torch.Tensor,
    item_embeddings: torch.Tensor,
    k: int,
    num_items: int | None = None,
    chunk: int = DEFAULT_CHUNK,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by chunk-max preselection (module docstring).

    ``chunk`` 32, the default, runs kernel 2 (``score_chunkmax``, the only
    chunk the kernel has, as the Pallas kernel) and ``select_topk`` at every
    V: a table off the chunk is padded to it first (a copy of the table), and
    ``select_topk`` sorts the whole row when there are fewer than k chunks.
    Any other chunk scores with one plain matmul on the given device and
    selects in PyTorch, with the JAX package's dense fallbacks: V below
    ``MIN_ROWS_FOR_TWO_LEVEL``, V not a multiple of the chunk, or fewer than
    k chunks. Every branch returns the dense top-k.
    """
    V = item_embeddings.shape[0]
    if chunk == CHUNK:
        s, i = select_topk(*_score_chunkmax_any_rows(session_embeddings, item_embeddings, num_items, exclude), k)
        return s[:, :V], i[:, :V]  # k > V: no padding column
    if V < MIN_ROWS_FOR_TWO_LEVEL or V % chunk or V // chunk < k:
        return dense_topk(session_embeddings, item_embeddings, k, num_items, exclude)
    scores = masked_scores(session_embeddings, item_embeddings, num_items, exclude)
    return two_level_topk_scores(scores, k, chunk)


def approx_topk(
    session_embeddings: torch.Tensor,
    item_embeddings: torch.Tensor,
    k: int,
    num_items: int | None = None,
    candidates: int = DEFAULT_CANDIDATES,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The top k of L = max(candidates, k) candidates (the JAX package's
    ``lax.approx_max_k`` over L, then ``lax.top_k``); the dense top-k when
    L >= V, as there.

    Exact on every device: the L candidates are ``two_level_topk``'s stable
    top L (kernel 2 and its chunk maxes), so the result equals the dense
    top-k, ties included. On the JAX CPU backend ``approx_max_k`` is exact
    too, so the ids equal the JAX package's there; on a TPU it is not (about
    97.5 % top-20 agreement at L = 128).
    """
    L = max(candidates, k)
    if L >= item_embeddings.shape[0]:
        return dense_topk(session_embeddings, item_embeddings, k, num_items, exclude)
    s, i = two_level_topk(session_embeddings, item_embeddings, L, num_items, exclude=exclude)
    return s[:, :k], i[:, :k]


def full_catalog_topk(
    session_embeddings: torch.Tensor,
    item_embeddings: torch.Tensor,
    k: int,
    num_items: int | None = None,
    method: str = "auto",
    exclude: torch.Tensor | None = None,
    **kwargs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: 'auto' or 'two_level' (``two_level_topk``; kwargs: chunk) |
    'dense' (the oracle) | 'approx' (``approx_topk``; kwargs: candidates).
    `exclude` ([B, V], or [V] when B == 1) masks columns to -inf like the
    phantom tail. Returns (scores [B, k], indices [B, k])."""
    if method in ("auto", "two_level"):
        return two_level_topk(session_embeddings, item_embeddings, k, num_items, exclude=exclude, **kwargs)
    if method == "dense":
        return dense_topk(session_embeddings, item_embeddings, k, num_items, exclude)
    if method == "approx":
        return approx_topk(session_embeddings, item_embeddings, k, num_items, exclude=exclude, **kwargs)
    raise ValueError(f"Unknown top-k method: {method}")
