"""TransformerConv as batched dense masked attention over [B, N, D] nodes.

The math of PyG ``TransformerConv(in, out//H, heads=H, concat=True,
beta=True)`` on the fixed-shape node tensor with a per-session adjacency
``adj[b, dst, src]``: attention rows are destinations and the softmax runs
over sources. The attention core is ``ops/session_attention.py`` (CUDA
kernels on the card, forward and backward, with attention dropout).
"""

from __future__ import annotations

import torch
from torch import nn

from gat_recommendation_torch.models.base import init_torch_linear
from gat_recommendation_torch.ops.session_attention import session_attention


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
        self, x: torch.Tensor, adj: torch.Tensor, dropout_p: float = 0.0, seed: int | None = None
    ) -> torch.Tensor:
        """x: [B, N, in]; adj: [B, N, N] bool. Returns [B, N, heads*head_dim].
        `dropout_p` > 0 drops attention weights, keyed by the 64-bit `seed`."""
        out = session_attention(
            self.query(x), self.key(x), self.value(x), adj, self.heads, dropout_p, seed
        )
        x_r = self.skip(x)
        beta = torch.sigmoid(self.beta(torch.cat([out, x_r, out - x_r], dim=-1)))
        return beta * x_r + (1.0 - beta) * out
