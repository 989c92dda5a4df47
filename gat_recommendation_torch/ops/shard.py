"""The shard of the batch and of the item table that this process works on.

Under a ('data', 'model') mesh (``gat_recommendation_torch/parallel/``) a
process holds sessions ``[first_session, first_session + b)`` of every global
batch and rows ``[row_offset, row_offset + rows)`` of the item table (and of
everything shaped like it). What one GPU computes over the whole batch or the
whole table, the process computes over its shard, with the collectives that
GSPMD inserted in the JAX package written out:

- ``sum_over_data``: the BatchNorm statistics (``ops/masked.py``) and the
  loss's count of valid samples (``train/losses.py``) are summed over the data
  group, forward and backward, so every rank normalizes and averages with the
  global batch's numbers;
- ``first_session``: the dropout counters of a data rank start at its first
  session (``ops/node_dropout.py``, ``ops/session_attention.py``), so it draws
  at its rows the bits that the whole batch draws on one GPU;
- ``lookup``: a rank reads its own rows of a row-sharded table, zeros for the
  others, and one sum over the model group gives every rank all the rows (the
  gradient goes back to the rank that owns each row).

``active(shard)`` sets the shard for the code inside it, on this thread. With
no shard active every function here is the single-GPU one.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Shard:
    """What a process of a mesh holds. A group of None is a group of one."""

    data_group: object = None  # the ranks that hold the other sessions of a batch
    first_session: int = 0  # the global batch row of this rank's first session
    model_group: object = None  # the ranks that hold the other rows of the table
    row_offset: int = 0  # the global row of this rank's first table row


_current: contextvars.ContextVar[Shard | None] = contextvars.ContextVar("shard", default=None)


def current() -> Shard | None:
    return _current.get()


@contextlib.contextmanager
def active(shard: Shard):
    token = _current.set(shard)
    try:
        yield shard
    finally:
        _current.reset(token)


def first_session() -> int:
    """The global index of this rank's first session (0 without a shard)."""
    shard = current()
    return 0 if shard is None else shard.first_session


class _SumOver(torch.autograd.Function):
    """A sum over a process group that autograd differentiates: each rank's
    loss reads the sum, so the gradient of the sum is summed too."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumOver.apply(grad, ctx.group), None


def sum_over_data(tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` summed over the active shard's data group, differentiable
    (itself without a shard or a group)."""
    shard = current()
    if shard is None or shard.data_group is None:
        return tensor
    return _SumOver.apply(tensor, shard.data_group)


class _ShardedLookup(torch.autograd.Function):
    """Rows `ids` (global) of a [rows, D] table row-sharded over `group`, this rank's
    rows at `row_offset`: each rank reads its own rows, zeros elsewhere, and
    one sum over the group fills every row (adding zeros is exact). The
    gradient of a row goes to its owner's table shard."""

    @staticmethod
    def forward(ctx, table, ids, group, row_offset):
        local = ids.long() - row_offset
        valid = (local >= 0) & (local < table.shape[0])
        out = torch.where(valid.unsqueeze(-1), table[torch.where(valid, local, 0)], 0.0)
        dist.all_reduce(out, group=group)
        ctx.save_for_backward(local, valid)
        ctx.table_shape = table.shape
        return out

    @staticmethod
    def backward(ctx, grad):
        local, valid = ctx.saved_tensors
        out = grad.new_zeros(ctx.table_shape)
        out.index_put_((local[valid],), grad[valid], accumulate=True)
        return out, None, None, None


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; under an active shard with a model group, `table` is
    this rank's row shard and `ids` are global rows."""
    shard = current()
    if shard is None or shard.model_group is None:
        return table[ids]
    return _ShardedLookup.apply(table, ids, shard.model_group, shard.row_offset)
