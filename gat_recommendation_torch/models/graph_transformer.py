"""Graph Transformer with Laplacian PE (the optimized variant is the serving model).

item emb (+ projected LapPE) -> num_layers x (TransformerConv(beta gate) ->
masked BatchNorm -> additive residual) -> session readout. Eval mode only in
this slice: the train-mode forward (dropout, attention dropout, running
statistics) and the FFN branch arrive with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from gat_recommendation_torch.data.batching import SessionBatch
from gat_recommendation_torch.models import base
from gat_recommendation_torch.models.layers import TransformerConv
from gat_recommendation_torch.ops.masked import masked_batch_norm


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


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid node slots (``ops.masked.masked_batch_norm``).

    Parameters ``scale``/``bias`` and buffers ``mean``/``var``/``count`` keep
    the JAX package's names.
    """

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))
        self.register_buffer("count", torch.zeros((), device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return masked_batch_norm(
            self.scale, self.bias, self.mean, self.var, self.count, x, mask, self.training
        )


class GraphTransformer(nn.Module):
    """The Graph Transformer as an ``nn.Module`` with ``name`` and ``config``.

    Parameters are allocated on `device` and drawn from `generator` (a
    ``torch.Generator`` on that device; seed 0 when omitted). On the "meta"
    device nothing is drawn: load real tensors with
    ``load_state_dict(..., assign=True)``, as the serving checkpoint loader does.
    """

    def __init__(
        self,
        cfg: GraphTransformerConfig,
        name: str = "graph_transformer",
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if cfg.use_ffn:
            raise NotImplementedError(
                "the FFN branch of the Graph Transformer is not ported yet (ROADMAP.md, queue A)"
            )
        if cfg.readout_type not in base.READOUT_TYPES:
            raise ValueError(f"Unknown readout type: {cfg.readout_type}")
        self.name = name
        self.config = cfg
        rows = base.padded_rows(cfg.num_items)
        self.item_embedding = nn.Parameter(torch.empty(rows, cfg.embedding_dim, device=device))
        self.readout = (
            nn.Linear(cfg.hidden_dim, 1, device=device) if cfg.readout_type == "attention" else None
        )
        self.lap_projection = None
        if cfg.use_laplacian_pe:
            self.lap_projection = nn.Linear(cfg.laplacian_k, cfg.embedding_dim, device=device)
            self.register_buffer("cached_pe", torch.zeros(rows, cfg.laplacian_k, device=device))
        head_dim = cfg.hidden_dim // cfg.num_heads
        dims = [cfg.embedding_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
        self.convs = nn.ModuleList(
            TransformerConv(d, head_dim, cfg.num_heads, device=device) for d in dims
        )
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(cfg.hidden_dim, device=device) for _ in dims
        )
        if self.item_embedding.device.type != "meta":
            if generator is None:
                generator = torch.Generator(self.item_embedding.device).manual_seed(0)
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from `generator`; BatchNorm starts at identity."""
        base.init_item_embedding(self.item_embedding, self.config.num_items, generator)
        if self.readout is not None:
            base.init_xavier_linear(self.readout, generator)
        if self.lap_projection is not None:
            base.init_xavier_linear(self.lap_projection, generator)
        for conv in self.convs:
            conv.reset_parameters(generator)

    def forward(self, batch: SessionBatch) -> torch.Tensor:
        """Eval-mode forward. Returns session embeddings [B, hidden_dim]."""
        if self.training:
            raise NotImplementedError(
                "the train-mode forward is not ported yet (ROADMAP.md, queue A); call .eval()"
            )
        x = self.item_embedding[batch.node_ids]  # [B, N, D]
        if self.lap_projection is not None:
            x = x + self.lap_projection(self.cached_pe[batch.node_ids])
        for conv, bn in zip(self.convs, self.batch_norms):
            residual = x
            x = bn(conv(x, batch.adj), batch.node_mask)
            x = x + residual
        return base.apply_readout(
            self.readout, x, batch.node_mask, batch.num_nodes, self.config.readout_type
        )


def create_graph_transformer(num_items: int, *, device=None, generator=None, **kwargs):
    """Standard factory (its FFN default raises until the FFN branch is ported)."""
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
