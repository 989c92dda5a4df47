"""Model factory dispatch by name (the JAX package's model names)."""

from __future__ import annotations

from torch import nn

from gat_recommendation_torch.models.base import SessionModel
from gat_recommendation_torch.models.gat import create_gat
from gat_recommendation_torch.models.graph_transformer import (
    create_graph_transformer,
    create_graph_transformer_optimized,
)
from gat_recommendation_torch.models.graphsage import create_graphsage

_FACTORIES = {
    "graphsage": create_graphsage,
    "gat": create_gat,
    "graph_transformer": create_graph_transformer,
    "graph_transformer_optimized": create_graph_transformer_optimized,
}
MODEL_NAMES = tuple(_FACTORIES)


def create_model(name: str, num_items: int, **kwargs) -> SessionModel:
    """Build a model by name; kwargs are the config fields plus `device` and
    `generator`. The model is allocated on ``cuda`` unless the caller passes
    `device` (``"cpu"``, or ``"meta"`` for a module that a checkpoint fills);
    without a CUDA device the default raises."""
    if name not in _FACTORIES:
        raise ValueError(f"Unknown model: {name} (expected one of {MODEL_NAMES})")
    return _FACTORIES[name](num_items, **kwargs)


def count_params(model: nn.Module) -> int:
    """The number of parameter elements (buffers such as ``cached_pe`` and the
    BatchNorm statistics are state, not parameters)."""
    return sum(p.numel() for p in model.parameters())
