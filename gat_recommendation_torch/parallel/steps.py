"""Sharded train and eval steps over a ('data', 'model') mesh.

The single-GPU steps of ``train/trainer.py`` with the collectives that GSPMD
inserts in the JAX package (``parallel/steps.py`` there) written out. Each
rank holds its data coordinate's sessions of every global batch and its model
coordinate's rows of the table (``parallel/mesh.py``); the ranks of a model
group hold the same sessions and compute the same forward.

The sparse step (eager with B1, or lazy):

1. the GradIndex is the GLOBAL batch's (``make_grad_index_from_ids`` over the
   global meta's ids), the same on every rank;
2. the rows of ``uid``: each model rank reads (eager) or gathers and catches
   up (lazy) its own rows, zeros for the others', and one ``all_reduce`` over
   the model group gives every rank all of them;
3. forward and backward on this rank's slots, with the shard active
   (``ops/shard.py``): BatchNorm statistics and the loss's sample count summed
   over the data group, dropout counters from the rank's first session;
4. the slot gradients scattered into the global slots and summed per unique
   row through the GradIndex, then ``all_reduce`` over the data group; the
   padding row zeroed;
5. the other parameters' gradients ``all_reduce``d over the data group;
6. B1 (``sharded_sparse_adamw``) or the lazy touched update on each shard.

The table is never gathered whole. The dense step reads rows through the
sharded lookup (the gradient lands on the owner's rows) and runs kernel 4 on
each shard. The eval step is the eval forward and the two-phase top-k
(``parallel/topk.py``). Every step returns the global batch's loss.

The chained sparse step runs C such steps over a chain group's stacked
batches and GradIndexes: on the CPU a loop over the slots, on the card CUDA
graphs of one step (``train/trainer.py::chain_steps``) with the step's NCCL
collectives captured inside them, replayed C times. Slot i is the unchained
step with the i-th row of the step block, so a chained run equals the
unchained one bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from gat_recommendation_torch.data.batching import GradIndex, SessionBatch, make_grad_index, to_device
from gat_recommendation_torch.ops import shard
from gat_recommendation_torch.parallel.mesh import (
    axis_size,
    coordinates,
    device_of,
    shard_params,
)
from gat_recommendation_torch.parallel.topk import sharded_topk
from gat_recommendation_torch.train.optimizers import EMBEDDING_KEY, rest_parameters
from gat_recommendation_torch.train.trainer import chain_steps, next_steps_block, single_step, sorted_segment_sum

__all__ = [
    "make_chained_sharded_sparse_train_step",
    "make_sharded_sparse_train_step",
    "make_sharded_train_step",
    "make_sharded_eval_step",
    "shard_batch",
    "shard_chained_batch",
    "shard_params",
]


def active_shard(model: nn.Module, mesh, local_batch: int) -> shard.Shard:
    """The shard of this rank: its data group and first session (for a local
    batch of `local_batch` sessions), its model group and first table row."""
    d, _ = coordinates(mesh)
    return shard.Shard(data_group=mesh.get_group("data"), first_session=d * local_batch,
                       model_group=mesh.get_group("model"), row_offset=getattr(model, "table_offset", 0))


def _data_rows(B: int, mesh) -> slice:
    """This rank's sessions ``[d * b, (d + 1) * b)`` of a global batch of B, b = B / n_data."""
    n_data = axis_size(mesh, "data")
    if B % n_data:
        raise ValueError(f"batch of {B} does not split over {n_data} data ranks")
    b = B // n_data
    d, _ = coordinates(mesh)
    return slice(d * b, (d + 1) * b)


def shard_batch(batch: SessionBatch, mesh):
    """This rank's rows of a whole host batch on its device (``batch_sharding``)."""
    rows = _data_rows(batch.batch_size, mesh)
    return to_device(batch.map(lambda t: t[rows]), device_of(mesh))


def shard_chained_batch(stacked: SessionBatch, mesh):
    """This rank's rows of every slot of a chain group's stacked host batches
    [C, B, ...] on its device, the chain axis whole (``chained_batch_sharding``)."""
    rows = _data_rows(stacked.node_ids.shape[1], mesh)
    return to_device(stacked.map(lambda t: t[:, rows]), device_of(mesh))


def _local_slots(b: int, N: int, K: int, mesh, device) -> torch.Tensor:
    """Positions of this rank's slots in the global id list
    concat(node_ids.flat [B*N], targets [B], negatives.flat [B*K])."""
    n_data = axis_size(mesh, "data")
    B, b0 = b * n_data, coordinates(mesh)[0] * b
    return torch.cat([torch.arange(b0 * N, (b0 + b) * N), B * N + torch.arange(b0, b0 + b),
                      B * N + B + torch.arange(b0 * K, (b0 + b) * K)]).to(device)


def _sum_over(tensors: list, group) -> list:
    """Each tensor (None stays None) summed over `group`, in one collective."""
    present = [t for t in tensors if t is not None]
    if not present:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in present])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def _global_loss(loss: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of the global mean, summed over the data group."""
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=mesh.get_group("data"))
    return loss


def _with_index(batch, device):
    """(batch, GradIndex on device): a given pair, or the index of a bare
    batch (then the batch must be the global one: one data rank)."""
    if isinstance(batch, tuple):
        return batch
    return batch, to_device(make_grad_index(batch.to("cpu")), device)


def _sharded_sparse_body(model: nn.Module, loss_fn, optimizer, opt_state: dict, mesh) -> Callable:
    """``body(batch, gidx, row) -> global loss``: one sparse step over the mesh
    on device tensors, `batch` this rank's sessions, `gidx` the global batch's
    GradIndex, `row` the step's row of the step block. Shared by the single
    step and the chained one, whose graphs capture it with its collectives.
    The slot positions of a shape are built at its first call (the warm-up,
    on the card), so a graph reads a tensor that stays alive."""
    if not hasattr(optimizer, "update_sparse"):
        raise TypeError("optimizer must support update_sparse")
    lazy = getattr(optimizer, "lazy", False)
    model_group, data_group = mesh.get_group("model"), mesh.get_group("data")
    slots_by_shape: dict = {}

    def body(batch: SessionBatch, gidx: GradIndex, row: torch.Tensor) -> torch.Tensor:
        model.train()
        b, N = batch.node_ids.shape
        K = batch.negatives.shape[1]
        key = (b, N, K)
        if key not in slots_by_shape:
            slots_by_shape[key] = _local_slots(b, N, K, mesh, batch.node_ids.device)
        slots = slots_by_shape[key]
        table = model.get_parameter(EMBEDDING_KEY).detach()
        if lazy:
            caught = torch.stack(optimizer.gather_catch_up(model, opt_state, gidx.uid, step=row))
            dist.all_reduce(caught, group=model_group)
            w_c, mu_c, nu_c = caught.unbind(0)
            unique_rows = w_c
        else:
            local = gidx.uid.long() - model.table_offset
            mine = (local >= 0) & (local < table.shape[0])
            unique_rows = torch.where(mine[:, None], table[torch.where(mine, local, 0)], 0.0)
            dist.all_reduce(unique_rows, group=model_group)
        u_of_r = torch.empty_like(gidx.perm)  # perm is a permutation: every slot is set once
        u_of_r[gidx.perm] = gidx.seg
        rows = unique_rows[u_of_r[slots]].requires_grad_(True)
        node_emb = rows[: b * N].view(b, N, -1)
        target_emb = rows[b * N : b * N + b]
        neg_emb = rows[b * N + b :].view(b, K, -1)
        other = rest_parameters(model)
        with shard.active(active_shard(model, mesh, b)):
            sess = model(batch, node_embeddings=node_emb, seed=row)
            loss, _aux = loss_fn.from_embeddings(sess, target_emb, neg_emb, batch.sample_mask)
            *g_other, g_rows = torch.autograd.grad(loss, [*other.values(), rows], allow_unused=True)
        g_slots = g_rows.new_zeros(gidx.ids.shape[0], g_rows.shape[1])
        g_slots[slots] = g_rows
        summed = sorted_segment_sum(g_slots[gidx.perm], gidx.lengths)
        dist.all_reduce(summed, group=data_group)
        summed = summed * (gidx.uid != 0)[:, None]
        g_rest = dict(zip(other, _sum_over(g_other, data_group)))
        if lazy:
            optimizer.update_sparse_lazy(g_rest, gidx.uid, summed, w_c, mu_c, nu_c, opt_state, model, step=row)
        else:
            optimizer.update_sparse(g_rest, gidx.uid, summed, opt_state, model, step=row, mesh=mesh)
        return _global_loss(loss, mesh)

    return body


def make_sharded_sparse_train_step(model: nn.Module, loss_fn, optimizer, opt_state: dict, mesh) -> Callable:
    """The sparse step over the mesh: ``step(item, seed) -> global loss``.
    `item` is (this rank's batch, the global batch's GradIndex) on the
    rank's device, or a bare batch on a mesh of one data rank. Eager
    optimizers update the table with B1 (``update_sparse(mesh=)``); lazy
    ones through the row kernels at the shard's offset."""
    body = _sharded_sparse_body(model, loss_fn, optimizer, opt_state, mesh)

    def train_step(item, seed: int = 0) -> torch.Tensor:
        if not isinstance(item, tuple) and axis_size(mesh, "data") > 1:
            raise ValueError("with several data ranks the step needs the global batch's GradIndex")
        device = device_of(mesh)
        batch, gidx = _with_index(item, device)
        return body(batch, gidx, next_steps_block(model, optimizer, opt_state, [seed], device)[0])

    return single_step(train_step, opt_state)


def make_chained_sharded_sparse_train_step(model: nn.Module, loss_fn, optimizer, opt_state: dict,
                                           mesh) -> Callable:
    """C sparse steps over the mesh in one call: ``chained(batches, gidxs,
    block) -> global losses [C]``, the contract of the single-GPU
    ``make_chained_sparse_train_step``. `batches` are this rank's rows of the
    group's stacked batches (``shard_chained_batch``), `gidxs` the stacked
    GradIndexes of the global batches (``stack_grad_indices`` over
    ``make_grad_index_from_ids``), the same on every rank; slot i is the
    unchained sharded step with ``block[i]``'s seed.

    On the CPU (gloo) a loop over the slots. On the card one CUDA graph of a
    sharded step per (node bucket, U), its NCCL collectives captured inside
    (the uid and PE rows over 'model'; BatchNorm statistics and their
    gradients, the loss's counts, the summed rows, the other gradients and
    the loss over 'data'), replayed C times. The warm-up before each capture
    runs every collective of the step for real, so each group's communicator
    exists before the capture begins. Every rank must form the same groups:
    a rank that replays a graph its peers do not waits in NCCL until the
    group's timeout."""
    body = _sharded_sparse_body(model, loss_fn, optimizer, opt_state, mesh)
    return chain_steps(body, model, opt_state)


def make_sharded_train_step(model: nn.Module, loss_fn, optimizer, opt_state: dict, mesh) -> Callable:
    """The dense-gradient step over the mesh: ``step(batch, seed) -> global
    loss``, `batch` this rank's sessions on its device. The table's rows are
    read through the model group (``ops/shard.py::lookup``), so each rank's
    table gradient is a dense gradient of its own rows; every gradient is
    summed over the data group, the padding row (on shard 0) zeroed, and
    kernel 4 runs on each shard (``update_full``)."""
    data_group = mesh.get_group("data")

    def train_step(batch: SessionBatch, seed: int = 0) -> torch.Tensor:
        model.train()
        params = dict(model.named_parameters())
        row = next_steps_block(model, optimizer, opt_state, [seed], batch.node_ids.device)[0]
        with shard.active(active_shard(model, mesh, batch.batch_size)):
            sess = model(batch, seed=row)
            loss, _aux = loss_fn(sess, batch.targets, batch.negatives, params[EMBEDDING_KEY], batch.sample_mask)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = dict(zip(params, _sum_over(list(grads), data_group)))
        if model.table_offset == 0:
            grads[EMBEDDING_KEY][0] = 0.0  # the padding item never updates
        optimizer.update_full(grads, opt_state, model, step=row)
        return _global_loss(loss, mesh)

    return single_step(train_step, opt_state)


def make_sharded_eval_step(model: nn.Module, k: int, mesh, method: str = "dense") -> Callable:
    """``step(batch) -> top-k ids [b, k]`` of this rank's sessions: the
    eval-mode forward with the table and encodings read through the model
    group, then ``sharded_topk`` (`method` "dense", the oracle a shard, as
    the JAX package's GSPMD step; ``parallel/topk.make_sharded_eval_step_v2``
    takes kernel 2)."""

    @torch.no_grad()
    def eval_step(batch: SessionBatch) -> torch.Tensor:
        model.eval()
        with shard.active(active_shard(model, mesh, batch.batch_size)):
            sess = model(batch)
        idx, _ = sharded_topk(sess, model.get_parameter(EMBEDDING_KEY), k, mesh, model.config.num_items, method)
        return idx

    return eval_step
