"""The port's checkpoint format: ``meta.json`` plus one ``torch.save`` file.

``meta.json`` holds ``model_name``, ``model_config``, ``epoch``,
``best_val_metric`` and ``leaf_paths``, the ``state_dict`` key of every saved
tensor. Restore checks that manifest against the model it fills, so a
renamed or reordered key fails loudly instead of misaligning tensors.
This is a new format: the JAX package's Orbax checkpoints are not readable
without JAX, and ``convert.from_jax_params`` carries weights across instead.
Optimizer state joins the format with the training slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import torch
from torch import nn

TENSORS_FILE = "tensors.pt"
META_FILE = "meta.json"


def save(
    path: str | Path,
    model: nn.Module,
    *,
    epoch: int = -1,
    best_val_metric: float = float("nan"),
) -> None:
    """Write ``model``'s parameters and buffers plus the meta sidecar to ``path``.

    The model must carry ``name`` and a dataclass ``config`` (as
    ``GraphTransformer`` does). Each file is written under a temporary name
    and renamed into place, so an interrupted save leaves no half file.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tensors = model.state_dict()
    meta = {
        "model_name": model.name,
        "model_config": dataclasses.asdict(model.config),
        "epoch": epoch,
        "best_val_metric": best_val_metric,
        "leaf_paths": list(tensors),
    }
    tmp = path / (TENSORS_FILE + ".tmp")
    torch.save(tensors, tmp)
    os.replace(tmp, path / TENSORS_FILE)
    tmp = path / (META_FILE + ".tmp")
    tmp.write_text(json.dumps(meta, indent=2))
    os.replace(tmp, path / META_FILE)


def load_meta(path: str | Path) -> dict:
    return json.loads((Path(path) / META_FILE).read_text())


def restore_params_state(path: str | Path, model: nn.Module, map_location=None) -> nn.Module:
    """Fill ``model``'s parameters and buffers (its params and state) from ``path``.

    Tensors load onto `map_location` and are assigned into the module, so a
    module built on the "meta" device takes them without a copy. Raises
    ValueError if the manifest, the file and the module disagree on keys.
    """
    path = Path(path)
    saved = load_meta(path).get("leaf_paths")
    want = list(model.state_dict())
    if saved != want:
        saved = saved or []
        missing = [p for p in saved if p not in want]
        extra = [p for p in want if p not in saved]
        raise ValueError(
            "Checkpoint leaf-path manifest mismatch (renamed/reordered keys "
            f"would misalign tensors). In checkpoint only: {missing[:5]}; "
            f"in model only: {extra[:5]}"
        )
    tensors = torch.load(path / TENSORS_FILE, map_location=map_location, weights_only=True)
    if list(tensors) != saved:
        raise ValueError("Checkpoint tensor file does not match its meta.json manifest")
    model.load_state_dict(tensors, strict=True, assign=True)
    return model
