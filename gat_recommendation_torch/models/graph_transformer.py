"""Graph Transformer with Laplacian PE (the optimized variant is the serving model).

item emb (+ projected LapPE) -> num_layers x (TransformerConv(beta gate) ->
masked BatchNorm -> additive residual -> dropout [-> FFN(GELU) -> residual])
-> session readout. In train mode (``model.train()``) the BatchNorm layers use
batch statistics and update their running buffers in place, and the dropouts
are active, keyed by the `seed` the caller passes: an int, or a step's row of
the step block (``ops/step_block.py``) that holds every layer's seeds on the
device (two a layer, four with the FFN).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from gat_recommendation_torch.data.batching import SessionBatch
from gat_recommendation_torch.models import base
from gat_recommendation_torch.models.base import MaskedBatchNorm, SessionModel
from gat_recommendation_torch.models.laplacian_pe import compute_laplacian_pe
from gat_recommendation_torch.models.layers import FeedForward, TransformerConv
from gat_recommendation_torch.ops import step_block
from gat_recommendation_torch.ops.node_dropout import node_dropout


@dataclass(frozen=True)
class GraphTransformerConfig:
    num_items: int
    embedding_dim: int = 256
    hidden_dim: int = 256
    num_layers: int = 3
    num_heads: int = 4
    dropout: float = 0.1
    readout_type: str = "mean"
    use_laplacian_pe: bool = True
    laplacian_k: int = 16
    use_ffn: bool = True
    ffn_expansion: int = 4


class GraphTransformer(SessionModel):
    """The Graph Transformer as an ``nn.Module`` with ``name`` and ``config``
    (``SessionModel`` says where parameters live and how they are drawn).
    Each layer takes two seeds from a step row (attention dropout, node
    dropout), four with the FFN (its two dropouts)."""

    def __init__(
        self,
        cfg: GraphTransformerConfig,
        name: str = "graph_transformer",
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(cfg, name, device)
        device = self.item_embedding.device
        self.seeds_per_layer = 4 if cfg.use_ffn else 2
        self.lap_projection = None
        if cfg.use_laplacian_pe:
            self.lap_projection = nn.Linear(cfg.laplacian_k, cfg.embedding_dim, device=device)
            self.register_buffer(
                "cached_pe", torch.zeros(self.item_embedding.shape[0], cfg.laplacian_k, device=device)
            )
        head_dim = cfg.hidden_dim // cfg.num_heads
        dims = [cfg.embedding_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
        self.convs = nn.ModuleList(
            TransformerConv(d, head_dim, cfg.num_heads, device=device) for d in dims
        )
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(cfg.hidden_dim, device=device) for _ in dims
        )
        self.ffns = nn.ModuleList(
            FeedForward(cfg.hidden_dim, cfg.ffn_expansion, device=device) for _ in dims
        ) if cfg.use_ffn else None
        self._draw(generator)

    def _reset_layers(self, generator: torch.Generator) -> None:
        if self.lap_projection is not None:
            base.init_xavier_linear(self.lap_projection, generator)
        for layer, (conv, bn) in enumerate(zip(self.convs, self.batch_norms)):
            conv.reset_parameters(generator)
            bn.reset_parameters()
            if self.ffns is not None:
                self.ffns[layer].reset_parameters(generator)

    def precompute_pe(self, item_i, item_j) -> None:
        """Fill ``cached_pe`` in place, on the model's device, with the
        Laplacian eigenvectors of the co-occurrence graph (item_i[e],
        item_j[e]) (``models/laplacian_pe.py``, on the host); the padded
        phantom rows stay zero. Nothing without PE."""
        if not self.uses_laplacian_pe:
            return
        pe = compute_laplacian_pe(item_i, item_j, self.config.num_items, k=self.config.laplacian_k)
        with torch.no_grad():
            self.cached_pe.zero_()
            self.cached_pe[: pe.shape[0]].copy_(torch.from_numpy(pe))

    def forward(
        self,
        batch: SessionBatch,
        node_embeddings: torch.Tensor | None = None,
        seed: int | torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Session embeddings [B, hidden_dim]; train or eval by ``self.training``.

        `node_embeddings` ([B, N, D]) replaces the table lookup of
        ``batch.node_ids``: the sparse train step gathers every row it touches
        once and differentiates with respect to the rows. `seed` keys the
        train-mode randomness (0 when omitted): an int step seed, from which
        each layer derives on the host its seeds ``mix_seed(seed, layer, j)``
        (j = 0 attention dropout, 1 node dropout, 2 and 3 the FFN's), or a
        step's row of the step block holding those seeds on the device.
        """
        rate, seed = self._rate_and_seed(seed)
        x = self._nodes(batch, node_embeddings)
        if self.lap_projection is not None:
            x = x + self.lap_projection(self.cached_pe[batch.node_ids])
        for layer, (conv, bn) in enumerate(zip(self.convs, self.batch_norms)):
            residual = x
            seeds = step_block.layer_seeds(seed, layer, self.seeds_per_layer)
            x = conv(x, batch.adj, rate, seeds[0] if rate > 0.0 else None, packed=batch.adj_packed)
            x = bn(x, batch.node_mask) + residual
            x = node_dropout(x, rate, seeds[1])
            if self.ffns is not None:
                x = self.ffns[layer](x, rate, seeds[2:])
        return self._pool(x, batch)


def create_graph_transformer(num_items: int, *, device=None, generator=None, **kwargs):
    """Standard factory: 3 layers, 4 heads, the FFN."""
    cfg = GraphTransformerConfig(num_items=num_items, **kwargs)
    return GraphTransformer(cfg, "graph_transformer", device=device, generator=generator)


def create_graph_transformer_optimized(
    num_items: int,
    embedding_dim: int = 256,
    hidden_dim: int = 256,
    num_layers: int = 2,
    num_heads: int = 2,
    dropout: float = 0.1,
    readout_type: str = "mean",
    use_laplacian_pe: bool = True,
    laplacian_k: int = 16,
    use_ffn: bool = False,
    ffn_expansion: int = 2,
    *,
    device=None,
    generator: torch.Generator | None = None,
) -> GraphTransformer:
    """Optimized factory defaults: 2 layers, 2 heads, no FFN."""
    cfg = GraphTransformerConfig(
        num_items=num_items,
        embedding_dim=embedding_dim,
        hidden_dim=hidden_dim,
        num_layers=num_layers,
        num_heads=num_heads,
        dropout=dropout,
        readout_type=readout_type,
        use_laplacian_pe=use_laplacian_pe,
        laplacian_k=laplacian_k,
        use_ffn=use_ffn,
        ffn_expansion=ffn_expansion,
    )
    return GraphTransformer(
        cfg, "graph_transformer_optimized", device=device, generator=generator
    )
