"""Graph conv layers as batched dense masked attention and aggregation over [B, N, D] nodes.

Each layer is the math of its PyG counterpart as the reference models
configure it, on the fixed-shape node tensor with a per-session adjacency
``adj[b, dst, src]``: attention rows are destinations and the softmax (or
the aggregation) runs over sources.

- ``TransformerConv``: PyG ``TransformerConv(in, out//H, heads=H,
  concat=True, beta=True)``; its attention core is ``ops/session_attention.py``
  (CUDA kernels on the card, forward and backward, with attention dropout).
- ``GATConv``: PyG ``GATConv(in, out, heads=H, concat=...)`` with its
  defaults (LeakyReLU slope 0.2, self-loops); its attention dropout is
  ``ops/node_dropout.py`` on the weights.
- ``SAGEConv``: PyG ``SAGEConv(in, out, aggr=...)`` (root weight, no
  normalization) with the mean, max or LSTM aggregator.
- ``FeedForward``: the Graph Transformer's FFN branch.

The GAT and SAGE layers and the FFN are PyTorch operations (the JAX package
computes them in XLA, with no Pallas kernel); their dropouts are the node
dropout kernel on the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from gat_recommendation_torch.models.base import init_glorot, init_torch_linear
from gat_recommendation_torch.ops.masked import masked_softmax
from gat_recommendation_torch.ops.node_dropout import node_dropout
from gat_recommendation_torch.ops.session_attention import session_attention

SAGE_AGGREGATORS = ("mean", "max", "lstm")
_NEG_FILL = -1e30


class TransformerConv(nn.Module):
    """out_i = beta*W_skip x_i + (1-beta) * sum_j softmax_j(q_i.k_j/sqrt(d)) v_j,
    with beta = sigmoid(W_beta [out, x_r, out - x_r]). Destinations with no
    in-edges get attention output 0 before the beta-gated skip."""

    def __init__(self, in_dim: int, head_dim: int, heads: int, device=None):
        super().__init__()
        hd = heads * head_dim
        self.heads = heads
        self.query = nn.Linear(in_dim, hd, device=device)
        self.key = nn.Linear(in_dim, hd, device=device)
        self.value = nn.Linear(in_dim, hd, device=device)
        self.skip = nn.Linear(in_dim, hd, device=device)
        self.beta = nn.Linear(3 * hd, 1, bias=False, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.query, self.key, self.value, self.skip, self.beta):
            init_torch_linear(layer, generator)

    def forward(
        self,
        x: torch.Tensor,
        adj: torch.Tensor,
        dropout_p: float = 0.0,
        seed: int | torch.Tensor | None = None,
        packed: bool = False,
    ) -> torch.Tensor:
        """x: [B, N, in]; adj: [B, N, N] bool, or with `packed` the batch's
        bit-packed rows (``SessionBatch.adj_packed``), which kernel 1 reads as
        they are. Returns [B, N, heads*head_dim]. `dropout_p` > 0 drops
        attention weights, keyed by the 64-bit `seed` (an int, or a 0-dim
        int64 tensor on x's device holding its bits)."""
        out = session_attention(
            self.query(x), self.key(x), self.value(x), adj, self.heads, dropout_p, seed, packed
        )
        x_r = self.skip(x)
        beta = torch.sigmoid(self.beta(torch.cat([out, x_r, out - x_r], dim=-1)))
        return beta * x_r + (1.0 - beta) * out


class GATConv(nn.Module):
    """alpha_ij = softmax_j LeakyReLU(a_dst . W x_i + a_src . W x_j) over the
    sources j of destination i, the diagonal added for valid nodes (PyG
    ``add_self_loops=True``: every valid node attends at least to itself);
    out_i = sum_j alpha_ij W x_j per head, the heads concatenated or
    averaged, plus ``bias``. ``lin`` has no bias; ``att_src`` and
    ``att_dst`` are [heads, out] parameters, not linears."""

    def __init__(self, in_dim: int, out_dim: int, heads: int, concat: bool,
                 negative_slope: float = 0.2, device=None):
        super().__init__()
        self.concat = concat
        self.negative_slope = negative_slope
        self.lin = nn.Linear(in_dim, heads * out_dim, bias=False, device=device)
        self.att_src = nn.Parameter(torch.empty(heads, out_dim, device=device))
        self.att_dst = nn.Parameter(torch.empty(heads, out_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(heads * out_dim if concat else out_dim, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for t in (self.lin.weight, self.att_src, self.att_dst):
            init_glorot(t, generator)
        self.bias.zero_()

    def forward(
        self,
        x: torch.Tensor,
        adj: torch.Tensor,
        node_mask: torch.Tensor,
        dropout_p: float = 0.0,
        seed: int | torch.Tensor | None = None,
    ) -> torch.Tensor:
        """x: [B, N, in]; adj: [B, N, N] bool; node_mask: [B, N]. Returns
        [B, N, heads*out] (concat) or [B, N, out]. `dropout_p` > 0 drops
        attention weights ([B, heads, N, N]) through node dropout keyed by
        `seed` (an int, or a 0-dim int64 tensor on x's device)."""
        B, N, _ = x.shape
        heads, out_dim = self.att_src.shape
        h = self.lin(x).view(B, N, heads, out_dim)
        a_src = torch.einsum("bnhc,hc->bhn", h, self.att_src)
        a_dst = torch.einsum("bnhc,hc->bhn", h, self.att_dst)
        e = F.leaky_relu(a_dst[..., :, None] + a_src[..., None, :], self.negative_slope)  # [B, H, i, j]
        eye = torch.eye(N, dtype=torch.bool, device=x.device)
        adj_sl = (adj | eye) & node_mask[:, None, :] & node_mask[:, :, None]
        alpha = masked_softmax(e, adj_sl[:, None], dim=-1)
        alpha = node_dropout(alpha, dropout_p, seed)
        out = torch.einsum("bhij,bjhc->bihc", alpha, h)
        out = out.reshape(B, N, heads * out_dim) if self.concat else out.mean(dim=2)
        return out + self.bias


class LSTMAggregator(nn.Module):
    """An LSTM over each destination's sources in ascending local index (PyG
    ``SAGEConv(aggr='lstm')``, whose neighbour order is the edge order, here
    the sorted local index), hidden size = input size, gates in the order
    i, f, g, o. The parameters have ``torch.nn.LSTMCell``'s layout
    (``weight_ih`` [4D, D], applied as ``x @ weight_ih.T``) and its default
    init U(±1/sqrt(D)). A step over a slot that is not a neighbour leaves the
    state unchanged; a destination without neighbours aggregates to zero.

    One step per source slot, N in all, each a [B*N, D] x [D, 4D] product:
    the input term ``x_j @ weight_ih.T`` of every source is computed once up
    front, as it does not depend on the destination."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * dim, dim, device=device))
        self.weight_hh = nn.Parameter(torch.empty(4 * dim, dim, device=device))
        self.bias_ih = nn.Parameter(torch.empty(4 * dim, device=device))
        self.bias_hh = nn.Parameter(torch.empty(4 * dim, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight_hh.shape[1])
        for t in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            t.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x: [B, N, D]; adj: [B, N, N] bool (adj[b, i, j]: j is a source of i). Returns [B, N, D]."""
        B, N, D = x.shape
        x_in = x @ self.weight_ih.T  # [B, N_src, 4D]
        h = c = x.new_zeros(B, N, D)
        for j in range(N):
            gates = x_in[:, j, None, :] + h @ self.weight_hh.T + self.bias_ih + self.bias_hh
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = adj[:, :, j, None]
            h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
        return h


class SAGEConv(nn.Module):
    """out_i = lin_l(aggr({x_j : j -> i})) + lin_r(x_i); an empty
    neighbourhood aggregates to 0. mean: the sum over sources divided by
    max(degree, 1); max: the elementwise maximum over sources (non-sources
    filled with -1e30); lstm: ``LSTMAggregator``. ``lin_l`` has a bias,
    ``lin_r`` none."""

    def __init__(self, in_dim: int, out_dim: int, aggregator: str = "mean", device=None):
        super().__init__()
        if aggregator not in SAGE_AGGREGATORS:
            raise ValueError(f"Unknown SAGE aggregator: {aggregator}")
        self.aggregator = aggregator
        self.lin_l = nn.Linear(in_dim, out_dim, device=device)
        self.lin_r = nn.Linear(in_dim, out_dim, bias=False, device=device)
        self.lstm = LSTMAggregator(in_dim, device=device) if aggregator == "lstm" else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_torch_linear(self.lin_l, generator)
        init_torch_linear(self.lin_r, generator)
        if self.lstm is not None:
            self.lstm.reset_parameters(generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x: [B, N, in]; adj: [B, N, N] bool. Returns [B, N, out]."""
        if self.aggregator == "mean":
            a = adj.to(x.dtype)
            agg = (a @ x) / a.sum(dim=-1, keepdim=True).clamp_min(1.0)
        elif self.aggregator == "max":
            agg = torch.where(adj[..., None], x[:, None, :, :], _NEG_FILL).amax(dim=2)
            agg = torch.where(adj.any(dim=-1, keepdim=True), agg, 0.0)
        else:
            agg = self.lstm(x, adj)
        return self.lin_l(agg) + self.lin_r(x)


class FeedForward(nn.Module):
    """The Graph Transformer's FFN branch: x + drop(down(drop(GELU(up(x))))),
    the exact (erf) GELU; ``up`` widens by the expansion factor."""

    def __init__(self, dim: int, expansion: int, device=None):
        super().__init__()
        self.up = nn.Linear(dim, dim * expansion, device=device)
        self.down = nn.Linear(dim * expansion, dim, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_torch_linear(self.up, generator)
        init_torch_linear(self.down, generator)

    def forward(self, x: torch.Tensor, dropout_p: float = 0.0, seeds=(None, None)) -> torch.Tensor:
        """`seeds` key the two dropouts (after the GELU and after ``down``)."""
        h = node_dropout(F.gelu(self.up(x)), dropout_p, seeds[0])
        return node_dropout(self.down(h), dropout_p, seeds[1]) + x
