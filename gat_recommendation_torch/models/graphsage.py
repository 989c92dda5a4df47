"""GraphSAGE baseline: num_layers x (SAGEConv -> BatchNorm -> ReLU -> node
dropout) -> session readout, with the mean, max or LSTM aggregator. Each
layer takes one seed from a step row, its node dropout's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from gat_recommendation_torch.data.batching import SessionBatch
from gat_recommendation_torch.models.base import MaskedBatchNorm, SessionModel
from gat_recommendation_torch.models.layers import SAGEConv
from gat_recommendation_torch.ops import step_block
from gat_recommendation_torch.ops.node_dropout import node_dropout


@dataclass(frozen=True)
class GraphSAGEConfig:
    num_items: int
    embedding_dim: int = 256
    hidden_dim: int = 256
    num_layers: int = 3
    dropout: float = 0.1
    readout_type: str = "mean"
    aggregator: str = "mean"


class GraphSAGE(SessionModel):
    """``SessionModel`` says where parameters live and how they are drawn."""

    seeds_per_layer = 1

    def __init__(self, cfg: GraphSAGEConfig, name: str = "graphsage", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, name, device)
        device = self.item_embedding.device
        dims = [cfg.embedding_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
        self.convs = nn.ModuleList(SAGEConv(d, cfg.hidden_dim, cfg.aggregator, device=device) for d in dims)
        self.batch_norms = nn.ModuleList(MaskedBatchNorm(cfg.hidden_dim, device=device) for _ in dims)
        self._draw(generator)

    def _reset_layers(self, generator: torch.Generator) -> None:
        for conv, bn in zip(self.convs, self.batch_norms):
            conv.reset_parameters(generator)
            bn.reset_parameters()

    def forward(
        self,
        batch: SessionBatch,
        node_embeddings: torch.Tensor | None = None,
        seed: int | torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Session embeddings [B, hidden_dim] (the arguments as in ``GraphTransformer.forward``)."""
        rate, seed = self._rate_and_seed(seed)
        x = self._nodes(batch, node_embeddings)
        for layer, (conv, bn) in enumerate(zip(self.convs, self.batch_norms)):
            (node_seed,) = step_block.layer_seeds(seed, layer, self.seeds_per_layer)
            x = bn(conv(x, batch.adj), batch.node_mask)
            x = node_dropout(torch.relu(x), rate, node_seed)
        return self._pool(x, batch)


def create_graphsage(num_items: int, *, device=None, generator=None, **kwargs) -> GraphSAGE:
    return GraphSAGE(GraphSAGEConfig(num_items=num_items, **kwargs), "graphsage", device=device,
                     generator=generator)
