"""Model zoo: GraphSAGE, GAT and the Graph Transformer (with Laplacian PE),
each an ``nn.Module`` over the fixed-shape ``SessionBatch`` layout. The JAX
package's ``models.__all__``."""

from gat_recommendation_torch.models.base import (
    bpr_loss_from_embeddings,
    init_item_embedding,
    predict_topk,
)
from gat_recommendation_torch.models.gat import GATConfig, create_gat
from gat_recommendation_torch.models.graph_transformer import (
    GraphTransformerConfig,
    create_graph_transformer,
    create_graph_transformer_optimized,
)
from gat_recommendation_torch.models.graphsage import GraphSAGEConfig, create_graphsage
from gat_recommendation_torch.models.laplacian_pe import compute_laplacian_pe
from gat_recommendation_torch.models.registry import Model, create_model

__all__ = [
    "Model",
    "create_model",
    "create_graphsage",
    "create_gat",
    "create_graph_transformer",
    "create_graph_transformer_optimized",
    "GraphSAGEConfig",
    "GATConfig",
    "GraphTransformerConfig",
    "compute_laplacian_pe",
    "init_item_embedding",
    "predict_topk",
    "bpr_loss_from_embeddings",
]
