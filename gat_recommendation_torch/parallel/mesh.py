"""The ('data', 'model') device mesh and its sharding rules, over torch.distributed.

One process drives one GPU. The mesh lays the world's ranks out row-major as
``[n_data, n_model]`` (rank = data * n_model + model, as the JAX package
reshapes its device list):

* a batch is split over 'data' along its first axis: the ranks of one 'data'
  coordinate hold the same sessions;
* the item table and every tensor shaped like it (``TABLE_KEYS``: the table,
  its cached positional encodings, the optimizer's moments and ``last_step``)
  is split over 'model' into contiguous row blocks,
  ``[shard * rows_per_shard, (shard + 1) * rows_per_shard)``;
* everything else is replicated (the models' 28K-112K other parameters).

``shard_params`` cuts this rank's rows out of a whole model and optimizer
state; ``unshard`` puts a state's rows back together on rank 0 (checkpoints).
The table is padded to a 512-row multiple (``models/base.py``), so any power
of two up to 512 shards it evenly.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from gat_recommendation_torch.models.base import padded_rows

AXES = ("data", "model")
TABLE_KEYS = ("item_embedding", "cached_pe", "emb_mu", "emb_nu", "last_step")


class Sharding(NamedTuple):
    """How a tensor lies on the mesh: `spec` names the mesh axis each of its
    leading dimensions is split over (None: not split), as a JAX
    ``PartitionSpec``; the empty spec is replicated."""

    mesh: object
    spec: tuple


def make_mesh(n_data: int | None = None, n_model: int = 1, device: str = "cuda"):
    """A ('data', 'model') ``DeviceMesh`` over the initialised process group
    (``parallel/distributed.py``), on ``cuda`` unless the caller asks for
    ``cpu``. `n_data` None takes every rank the 'model' axis leaves. Raises,
    giving both counts, when the mesh wants more or fewer processes than the
    launch has, or more GPUs than this host shows; it never shrinks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (parallel.distributed.initialize)")
    world = dist.get_world_size()
    if n_data is None:
        if n_model < 1 or world % n_model:
            raise ValueError(f"a 'model' axis of {n_model} needs a multiple of {n_model} processes; "
                             f"the launch has {world}")
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} processes; the launch has {world}")
    if device == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local > torch.cuda.device_count():
            raise ValueError(f"a {n_data}x{n_model} mesh puts {local} processes on this host, one GPU each; "
                             f"{torch.cuda.device_count()} GPUs are visible")
    return init_device_mesh(device, (n_data, n_model), mesh_dim_names=AXES)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh) -> Sharding:
    """Batches split over 'data' on their leading (batch) axis."""
    return Sharding(mesh, ("data",))


def chained_batch_sharding(mesh) -> Sharding:
    """A chain group's stacked batches [C, B, ...]: the chain axis whole on
    every rank (each slot is a step of the whole mesh), the batch axis split
    over 'data'."""
    return Sharding(mesh, (None, "data"))


def is_table(name: str) -> bool:
    """A table-shaped tensor, by its state-dict or optimizer-state name."""
    return name.rsplit(".", 1)[-1] in TABLE_KEYS


def param_shardings(tensors: dict, mesh) -> dict:
    """The sharding of each named tensor (a model's ``state_dict``, or the
    optimizer's ``export_state``): table rows over 'model', the rest replicated."""
    return {name: Sharding(mesh, ("model", None)) if is_table(name) else replicated(mesh) for name in tensors}


state_shardings = param_shardings


def coordinates(mesh) -> tuple[int, int]:
    """This rank's (data, model) coordinates."""
    return mesh.get_local_rank("data"), mesh.get_local_rank("model")


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[AXES.index(axis)]


def device_of(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def row_block(rows: int, mesh) -> tuple[int, int]:
    """(first row, rows) of this rank's block of a `rows`-row table."""
    n_model = axis_size(mesh, "model")
    if rows % n_model:
        raise ValueError(f"{rows} table rows do not split into {n_model} equal shards")
    per = rows // n_model
    return coordinates(mesh)[1] * per, per


def _cut(t: torch.Tensor, mesh) -> torch.Tensor:
    lo, n = row_block(t.shape[0], mesh)
    return t.detach()[lo:lo + n].clone()


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Replace the model's whole table (and ``cached_pe``) by this rank's rows,
    in place, and set ``model.table_offset``. The other parameters stay and
    keep their identity."""
    table = model.get_parameter("item_embedding")
    if getattr(model, "table_offset", 0) or table.shape[0] != padded_rows(model.config.num_items):
        raise ValueError("shard_model takes a model that holds the whole table")
    lo, _ = row_block(table.shape[0], mesh)
    model.item_embedding = nn.Parameter(_cut(table, mesh))
    if getattr(model, "cached_pe", None) is not None:
        model.cached_pe = _cut(model.cached_pe, mesh)
    model.table_offset = lo
    return model


def shard_params(model: nn.Module, opt_state: dict | None, mesh) -> tuple[nn.Module, dict | None]:
    """Place a whole model and optimizer state on the mesh: this rank's rows
    of the table-shaped tensors (``shard_model``; ``emb_mu``, ``emb_nu`` and
    ``last_step`` of `opt_state`, cut in place of the dict), the rest as it
    is. A state built after ``shard_model`` by ``optimizer.init`` is already
    cut; pass None for it."""
    shard_model(model, mesh)
    if opt_state is not None:
        for key in TABLE_KEYS:
            if key in opt_state:
                opt_state[key] = _cut(opt_state[key], mesh)
    return model, opt_state


def unshard(tensors: dict, mesh, dst: int = 0) -> dict | None:
    """A whole state from each rank's rows: on global rank `dst` the dict with
    every table-shaped tensor gathered over the model group (in row order),
    the rest as they are; None on the other ranks. Collective over the model
    group of `dst`'s data coordinate; the other ranks call it too and return
    at once."""
    n_model = axis_size(mesh, "model")
    if dist.get_rank() // n_model != dst // n_model:
        return None
    group = mesh.get_group("model")
    out = {}
    for name, t in tensors.items():
        if not is_table(name):
            out[name] = t
            continue
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(n_model)] if dist.get_rank() == dst else None
        dist.gather(t, parts, dst=dst, group=group)
        out[name] = torch.cat(parts) if parts is not None else None
    return out if dist.get_rank() == dst else None
