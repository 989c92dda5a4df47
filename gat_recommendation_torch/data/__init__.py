"""Data layer: the host pipeline (synthetic events, sessionize, temporal
splits, the co-occurrence graph) and the bucketed fixed-shape batching
engines (numpy and the C++ engine of ``native/``). The JAX package's
``data.__all__``, in numpy and the csv module, without pandas."""

from gat_recommendation_torch.data.graph import build_co_event_graph
from gat_recommendation_torch.data.sessionize import compute_session_stats, sessionize_events
from gat_recommendation_torch.data.splits import create_temporal_splits
from gat_recommendation_torch.data.synthetic import (
    generate_structured_events,
    generate_synthetic_events,
)

__all__ = [
    "build_co_event_graph",
    "compute_session_stats",
    "create_temporal_splits",
    "generate_structured_events",
    "generate_synthetic_events",
    "sessionize_events",
]
