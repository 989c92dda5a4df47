"""The port's checkpoint format: ``meta.json``, ``tensors.pt`` and, for
training, ``optimizer.pt``.

``meta.json`` holds ``model_name``, ``model_config``, ``epoch``,
``best_val_metric``, ``history`` (the Trainer's losses and metrics so far)
and two manifests: ``leaf_paths``, the ``state_dict`` key of every tensor in
``tensors.pt`` (the model's parameters and buffers), and
``optimizer_paths``, the key of every tensor in ``optimizer.pt`` (the flat
dict of ``FusedEmbeddingAdamW.export_state``: the table's moments, ``count``,
the lazy optimizer's ``last_step``, each other parameter's ``step``,
``exp_avg`` and ``exp_avg_sq``; empty when no optimizer state was saved).
Restore checks each manifest against its file and against what it fills, so
a renamed or reordered key fails loudly instead of misaligning tensors.

The optimizer file stands apart, so ``restore_params_state`` (the server's
loader) reads a checkpoint written by training without knowing the
optimizer. The Trainer materializes the lazy optimizer before it saves, so
the table is the dense-AdamW trajectory's and ``last_step`` equals ``count``.
This is a new format: the JAX package's Orbax checkpoints are not readable
without JAX, and ``convert.from_jax_params`` carries weights across instead.

A Trainer over a mesh gathers the table-shaped tensors to rank 0, which
writes this same file (``parallel/mesh.py::unshard``); ``restore`` onto a
model that holds a row shard (``model.table_offset``) cuts its rows out of
the whole table, so a checkpoint saved under any mesh or on one GPU loads
under any other mesh or on one GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import torch
from torch import nn

TENSORS_FILE = "tensors.pt"
OPTIMIZER_FILE = "optimizer.pt"
META_FILE = "meta.json"


def _write(path: Path, name: str, write) -> None:
    """Write one file under a temporary name and rename it into place."""
    tmp = path / (name + ".tmp")
    write(tmp)
    os.replace(tmp, path / name)


def save(
    path: str | Path,
    model: nn.Module,
    *,
    epoch: int = -1,
    best_val_metric: float = float("nan"),
    history: dict | None = None,
    optimizer_state: dict[str, torch.Tensor] | None = None,
    model_state: dict[str, torch.Tensor] | None = None,
) -> None:
    """Write ``model``'s parameters and buffers (or `model_state`, a state
    dict of it, e.g. a snapshot), `optimizer_state` (a flat dict of tensors)
    when given, and the meta sidecar to ``path``.

    The model must carry ``name`` and a dataclass ``config`` (as
    ``GraphTransformer`` does). Each file is written under a temporary name
    and renamed into place, ``meta.json`` last, so an interrupted save leaves
    no half file and no manifest of files not yet written.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tensors = model.state_dict() if model_state is None else model_state
    optimizer_state = optimizer_state or {}
    meta = {
        "model_name": model.name,
        "model_config": dataclasses.asdict(model.config),
        "epoch": epoch,
        "best_val_metric": best_val_metric,
        "history": history or {},
        "leaf_paths": list(tensors),
        "optimizer_paths": list(optimizer_state),
    }
    _write(path, TENSORS_FILE, lambda tmp: torch.save(tensors, tmp))
    if optimizer_state:
        _write(path, OPTIMIZER_FILE, lambda tmp: torch.save(optimizer_state, tmp))
    _write(path, META_FILE, lambda tmp: tmp.write_text(json.dumps(meta, indent=2)))


def load_meta(path: str | Path) -> dict:
    return json.loads((Path(path) / META_FILE).read_text())


def _check_manifest(saved: list | None, want: list, what: str) -> None:
    if saved != want:
        saved = saved or []
        missing = [p for p in saved if p not in want]
        extra = [p for p in want if p not in saved]
        raise ValueError(
            f"Checkpoint {what} manifest mismatch (renamed/reordered keys would "
            f"misalign tensors). In checkpoint only: {missing[:5]}; in {what} only: {extra[:5]}"
        )


def _load(path: Path, name: str, manifest: list, map_location) -> dict:
    tensors = torch.load(path / name, map_location=map_location, weights_only=True)
    if list(tensors) != manifest:
        raise ValueError(f"Checkpoint file {name} does not match its meta.json manifest")
    return tensors


def restore_params_state(path: str | Path, model: nn.Module, map_location=None) -> nn.Module:
    """Fill ``model``'s parameters and buffers (its params and state) from ``path``.

    Tensors load onto `map_location` and are assigned into the module, so a
    module built on the "meta" device takes them without a copy. Raises
    ValueError if the manifest, the file and the module disagree on keys.
    """
    path = Path(path)
    saved = load_meta(path).get("leaf_paths")
    _check_manifest(saved, list(model.state_dict()), "model")
    model.load_state_dict(_load(path, TENSORS_FILE, saved, map_location), strict=True, assign=True)
    return model


def _rows_held(saved: dict, held: dict, offset: int) -> dict:
    """`saved` with each table-shaped tensor cut to the rows that `held` (the
    tensors it fills) has, from global row `offset`: a row shard's rows."""
    from gat_recommendation_torch.parallel.mesh import is_table

    out = {}
    for name, t in saved.items():
        rows = held[name].shape[0] if name in held and held[name].dim() else None
        if is_table(name) and rows is not None and rows != t.shape[0]:
            t = t[offset:offset + rows]
        out[name] = t
    return out


def restore(path: str | Path, model: nn.Module, optimizer, opt_state: dict) -> dict:
    """Resume: copy the saved parameters and buffers INTO ``model`` (its
    tensors keep their identity, so an optimizer built over them stays
    bound) and fill `opt_state` (from ``optimizer.init(model)``) through
    ``optimizer.load_state``. Both manifests are checked first. A model that
    holds a row shard of the table takes its rows of the saved table (and of
    the moments and ``last_step``). Returns the meta dict."""
    path = Path(path)
    meta = load_meta(path)
    device = model.get_parameter("item_embedding").device
    _check_manifest(meta.get("leaf_paths"), list(model.state_dict()), "model")
    want = list(optimizer.export_state(opt_state, model))
    _check_manifest(meta.get("optimizer_paths"), want, "optimizer")
    offset = getattr(model, "table_offset", 0)
    tensors = _rows_held(_load(path, TENSORS_FILE, meta["leaf_paths"], device), model.state_dict(), offset)
    saved_opt = _rows_held(_load(path, OPTIMIZER_FILE, meta["optimizer_paths"], device),
                           optimizer.export_state(opt_state, model), offset)
    model.load_state_dict(tensors, strict=True)
    optimizer.load_state(opt_state, model, saved_opt)
    return meta
