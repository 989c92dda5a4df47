"""Shared model pieces: initializers, the padded item table, session readout.

Linear layers are ``nn.Linear`` (weight ``[out, in]``, apply ``x @ W.T + b``);
the JAX package stores ``w`` as ``[in, out]`` and ``convert.py`` transposes.
Initial values follow the JAX package's distributions, drawn from an
explicit ``torch.Generator`` (the numbers differ from JAX's for one seed).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gat_recommendation_torch.ops.masked import masked_max, masked_mean, masked_softmax

READOUT_TYPES = ("mean", "max", "last", "attention")

# Tables are padded to a row multiple so they row-shard evenly and tile
# evenly for row-tile kernels. Phantom rows are zero at init, receive no
# gradient (no id maps to them), and scoring masks them to -inf.
TABLE_PAD_MULTIPLE = 512


def padded_rows(num_items: int, multiple: int = TABLE_PAD_MULTIPLE) -> int:
    return -(-num_items // multiple) * multiple


@torch.no_grad()
def init_torch_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch.nn.Linear default init: weight and bias ~ U(±1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(layer.in_features) if layer.in_features > 0 else 0.0
    layer.weight.uniform_(-bound, bound, generator=generator)
    if layer.bias is not None:
        layer.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_xavier_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """xavier_uniform weight + zero bias (attention readout, LapPE projection)."""
    a = math.sqrt(6.0 / (layer.in_features + layer.out_features))
    layer.weight.uniform_(-a, a, generator=generator)
    if layer.bias is not None:
        layer.bias.zero_()


@torch.no_grad()
def init_item_embedding(
    table: torch.Tensor, num_items: int, generator: torch.Generator
) -> None:
    """Fill the [padded(num_items), D] table in place: row 0 (padding) zero,
    rows 1:num_items xavier_uniform with a = sqrt(6 / (num_items - 1 + D)),
    phantom tail rows zero."""
    a = math.sqrt(6.0 / (num_items - 1 + table.shape[1]))
    table.uniform_(-a, a, generator=generator)
    table[0] = 0.0
    table[num_items:] = 0.0


def mask_phantom(scores: torch.Tensor, num_items: int | None) -> torch.Tensor:
    """-inf the padded phantom columns beyond the logical catalog size."""
    if num_items is None or scores.shape[-1] <= num_items:
        return scores
    col = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(col < num_items, scores, torch.full_like(scores, -math.inf))


def apply_readout(
    attention: nn.Linear | None,
    x: torch.Tensor,
    node_mask: torch.Tensor,
    num_nodes: torch.Tensor,
    readout_type: str,
) -> torch.Tensor:
    """Pool node embeddings [B, N, D] -> session embeddings [B, D].

    'last' picks local index num_nodes-1: nodes are ascending item ids, so
    that is the largest item id (reference parity), not the latest event.
    """
    if readout_type == "mean":
        return masked_mean(x, node_mask, dim=1)
    if readout_type == "max":
        return masked_max(x, node_mask, dim=1)
    if readout_type == "last":
        idx = (num_nodes.long() - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx]
    if readout_type == "attention":
        weights = masked_softmax(attention(x)[..., 0], node_mask, dim=1)
        return torch.einsum("bn,bnd->bd", weights, x)
    raise ValueError(f"Unknown readout type: {readout_type}")
