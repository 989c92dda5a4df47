"""Model factory dispatch by name (the JAX package's model names)."""

from __future__ import annotations

from gat_recommendation_torch.models.graph_transformer import (
    GraphTransformer,
    create_graph_transformer,
    create_graph_transformer_optimized,
)

MODEL_NAMES = ("graphsage", "gat", "graph_transformer", "graph_transformer_optimized")


def create_model(name: str, num_items: int, **kwargs) -> GraphTransformer:
    """Build a model by name; kwargs are the config fields plus `device` and
    `generator`. The model is allocated on ``cuda`` unless the caller passes
    `device` (``"cpu"``, or ``"meta"`` for a module that a checkpoint fills);
    without a CUDA device the default raises. GraphSAGE and GAT are not
    ported yet."""
    if name == "graph_transformer":
        return create_graph_transformer(num_items, **kwargs)
    if name == "graph_transformer_optimized":
        return create_graph_transformer_optimized(num_items, **kwargs)
    if name in MODEL_NAMES:
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP.md, queue A)")
    raise ValueError(f"Unknown model: {name} (expected one of {MODEL_NAMES})")
