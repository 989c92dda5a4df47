"""Full-catalog top-k with the table row-sharded over 'model': two phases.

Each model rank scores its own rows and keeps a local top-k; only k
candidates per shard cross the model group (``all_gather``), never the
[B, V] scores or the table. The JAX package's ``parallel/topk.py`` does the
same under ``shard_map``.

Phase 1 on a shard is kernel 2 (``ops/scoring.py::two_level_topk``, chunk
32: ``score_chunkmax`` on the card) over the shard's rows, its phantom mask
set at ``clamp(V - offset, 0, shard_rows)`` valid rows, so padding rows and
a shard of padding alone score -inf (such a shard contributes -inf
candidates, and nothing fails). Local indices plus the shard's offset are
global rows. Phase 2 concatenates the candidates in ascending shard order and
takes a stable descending sort: equal scores keep the lowest global index,
as a dense top-k over the whole table does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gat_recommendation_torch.ops.score_chunkmax import CHUNK
from gat_recommendation_torch.ops.scoring import _stable_topk, dense_topk, two_level_topk
from gat_recommendation_torch.parallel.mesh import axis_size, coordinates


def pad_rows(table: torch.Tensor, n_model: int) -> torch.Tensor:
    """The whole table with zero rows appended to a multiple of
    ``n_model * 32``, so that every shard is a whole number of score chunks
    (done once, before the table is cut; the padding scores -inf)."""
    pad = (-table.shape[0]) % (n_model * CHUNK)
    return torch.cat([table, table.new_zeros(pad, table.shape[1])]) if pad else table


def sharded_topk(session_emb: torch.Tensor, table_shard: torch.Tensor, k: int, mesh, num_valid: int,
                 method: str = "two_level") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``session_emb @ table.T`` with the table row-sharded over the
    mesh's 'model' axis: `table_shard` is this rank's rows (shard s holds
    rows ``[s * shard_rows, (s + 1) * shard_rows)``), `num_valid` the catalog
    size (rows at or above it score -inf). `session_emb` [b, D] is the same on
    the ranks of a model group (their data rank's sessions). Returns
    (indices [b, k] int64 global rows, scores [b, k]), the same on every rank
    of the group. `method`: "two_level" (kernel 2) or "dense" (one plain
    product and sort a shard, the oracle)."""
    shard_rows = table_shard.shape[0]
    n_model = axis_size(mesh, "model")
    offset = coordinates(mesh)[1] * shard_rows
    valid = max(0, min(num_valid - offset, shard_rows))
    k_local = min(k, shard_rows)  # a shard holds no more candidates than rows
    if method == "two_level":
        vals, idx = two_level_topk(session_emb, table_shard, k_local, valid)
    elif method == "dense":
        vals, idx = dense_topk(session_emb, table_shard, k_local, valid)
    else:
        raise ValueError(f"Unknown top-k method: {method}")
    idx = idx + offset
    group = mesh.get_group("model")
    all_vals = [torch.empty_like(vals) for _ in range(n_model)]
    all_idx = [torch.empty_like(idx) for _ in range(n_model)]
    dist.all_gather(all_vals, vals.contiguous(), group=group)
    dist.all_gather(all_idx, idx.contiguous(), group=group)
    merged, pos = _stable_topk(torch.cat(all_vals, dim=1), k)
    return torch.gather(torch.cat(all_idx, dim=1), 1, pos), merged


def make_sharded_eval_step_v2(model, k: int, mesh):
    """``step(batch) -> top-k ids [b, k]`` of this rank's sessions: the
    eval-mode forward (table and encodings through the model group,
    ``ops/shard.py``), then ``sharded_topk`` through kernel 2."""
    from gat_recommendation_torch.parallel.steps import make_sharded_eval_step

    return make_sharded_eval_step(model, k, mesh, method="two_level")
