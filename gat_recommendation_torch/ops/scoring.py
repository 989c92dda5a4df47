"""Full-catalog exact top-k: score plus chunk-max (phase 1), then selection.

Phase 1 is ``ops/score_chunkmax.py`` (a CUDA kernel on the card). Phase 2
selects in PyTorch: the top-k chunks by their max, re-sorted into ascending
chunk order, then the top-k of the k*32 candidate scores.

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

from gat_recommendation_torch.ops.score_chunkmax import CHUNK, masked_scores, score_chunkmax


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


def full_catalog_topk(
    session_embeddings: torch.Tensor,
    item_embeddings: torch.Tensor,
    k: int,
    num_items: int | None = None,
    method: str = "auto",
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: 'auto' or 'two_level' (score_chunkmax, then select_topk) |
    'dense' (the oracle). `exclude` ([B, V], or [V] when B == 1) masks
    columns to -inf like the phantom tail. Returns (scores [B, k], indices [B, k])."""
    if method in ("auto", "two_level"):
        scores, maxes = score_chunkmax(session_embeddings, item_embeddings, num_items, exclude)
        return select_topk(scores, maxes, k)
    if method == "dense":
        return dense_topk(session_embeddings, item_embeddings, k, num_items, exclude)
    if method == "approx":
        raise NotImplementedError("approx_topk is not ported yet (ROADMAP.md, queue A)")
    raise ValueError(f"Unknown top-k method: {method}")
