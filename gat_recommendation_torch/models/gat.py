"""GAT baseline: num_layers GATConv layers, BatchNorm after each, ReLU and
node dropout after each but the last, then the session readout.

The first layer reads the embedding width; with ``concat_heads`` the middle
layers read (and their BatchNorm normalizes) hidden_dim * num_heads; the last
layer always averages its heads. Each layer takes two seeds from a step row:
its attention dropout's and its node dropout's (the last layer draws the
second, unused, so the layout is the Graph Transformer's).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from gat_recommendation_torch.data.batching import SessionBatch
from gat_recommendation_torch.models.base import MaskedBatchNorm, SessionModel
from gat_recommendation_torch.models.layers import GATConv
from gat_recommendation_torch.ops import step_block
from gat_recommendation_torch.ops.node_dropout import node_dropout


@dataclass(frozen=True)
class GATConfig:
    num_items: int
    embedding_dim: int = 256
    hidden_dim: int = 256
    num_layers: int = 3
    num_heads: int = 4
    dropout: float = 0.1
    readout_type: str = "mean"
    concat_heads: bool = False


def layer_plan(cfg: GATConfig) -> list[tuple[int, bool]]:
    """[(in_dim, concat)] per conv: the first, num_layers - 2 middle ones, and
    a last one that averages its heads."""
    plan = [(cfg.embedding_dim, cfg.concat_heads)]
    current = cfg.hidden_dim * cfg.num_heads if cfg.concat_heads else cfg.hidden_dim
    plan += [(current, cfg.concat_heads)] * (cfg.num_layers - 2)
    if cfg.num_layers > 1:
        plan.append((current, False))
    return plan


class GAT(SessionModel):
    """``SessionModel`` says where parameters live and how they are drawn."""

    seeds_per_layer = 2  # the attention dropout's and the node dropout's

    def __init__(self, cfg: GATConfig, name: str = "gat", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, name, device)
        device = self.item_embedding.device
        plan = layer_plan(cfg)
        width = lambda concat: cfg.hidden_dim * cfg.num_heads if concat else cfg.hidden_dim  # noqa: E731
        self.convs = nn.ModuleList(
            GATConv(in_dim, cfg.hidden_dim, cfg.num_heads, concat, device=device) for in_dim, concat in plan
        )
        self.batch_norms = nn.ModuleList(MaskedBatchNorm(width(concat), device=device) for _, concat in plan)
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
        adj = batch.dense_adj()  # unpacks the bit-packed transfer form once
        last = len(self.convs) - 1
        for layer, (conv, bn) in enumerate(zip(self.convs, self.batch_norms)):
            attention_seed, node_seed = step_block.layer_seeds(seed, layer, self.seeds_per_layer)
            x = bn(conv(x, adj, batch.node_mask, rate, attention_seed), batch.node_mask)
            if layer < last:
                x = node_dropout(torch.relu(x), rate, node_seed)
        return self._pool(x, batch)


def create_gat(num_items: int, *, device=None, generator=None, **kwargs) -> GAT:
    return GAT(GATConfig(num_items=num_items, **kwargs), "gat", device=device, generator=generator)
