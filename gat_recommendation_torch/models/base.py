"""Shared model pieces: initializers, the padded item table, session readout,
masked BatchNorm, and ``SessionModel``, the base of every model of the registry.

Linear layers are ``nn.Linear`` (weight ``[out, in]``, apply ``x @ W.T + b``);
the JAX package stores ``w`` as ``[in, out]`` and ``convert.py`` transposes.
Initial values follow the JAX package's distributions, drawn from an
explicit ``torch.Generator`` (the numbers differ from JAX's for one seed).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gat_recommendation_torch.data.batching import SessionBatch
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.ops.masked import (
    masked_batch_norm,
    masked_max,
    masked_mean,
    masked_softmax,
)

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
def init_glorot(tensor: torch.Tensor, generator: torch.Generator) -> None:
    """PyG glorot: U(±sqrt(6 / (size(-2) + size(-1)))); symmetric in the two
    sizes, so an ``nn.Linear`` weight ``[out, in]`` draws from the bound of
    the JAX package's ``[in, out]``."""
    a = math.sqrt(6.0 / (tensor.shape[-2] + tensor.shape[-1]))
    tensor.uniform_(-a, a, generator=generator)


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

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)
        self.count.zero_()

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return masked_batch_norm(
            self.scale, self.bias, self.mean, self.var, self.count, x, mask, self.training
        )


class SessionModel(nn.Module):
    """What every model of the registry shares: ``name`` and ``config`` (a
    dataclass with ``num_items``, ``embedding_dim``, ``hidden_dim``,
    ``num_layers``, ``dropout`` and ``readout_type``, which ``checkpoint.save``
    writes), the padded item table, the readout, ``reset_parameters`` and the
    positional-encoding hooks. A subclass builds its layers after this
    constructor, then calls ``_draw(generator)``, and implements
    ``forward(batch, node_embeddings=None, seed=None)`` and
    ``_reset_layers(generator)``.

    Each subclass states ``seeds_per_layer``: how many dropout seeds a layer
    takes from a step's row of the step block (``ops/step_block.py``), the
    layer's fields ``mix_seed(step_seed, layer, j)`` for j below it.

    Parameters are allocated on `device` (``cuda`` when None, which raises
    without a CUDA device; the CPU only for ``device="cpu"``) and drawn from
    `generator` (a ``torch.Generator`` on that device; seed 0 when omitted).
    On the "meta" device nothing is drawn: load real tensors with
    ``load_state_dict(..., assign=True)``, as the serving checkpoint loader does.
    """

    seeds_per_layer: int

    def __init__(self, cfg, name: str, device):
        super().__init__()
        if cfg.readout_type not in READOUT_TYPES:
            raise ValueError(f"Unknown readout type: {cfg.readout_type}")
        device = resolve_device(device)
        self.name = name
        self.config = cfg
        rows = padded_rows(cfg.num_items)
        self.item_embedding = nn.Parameter(torch.empty(rows, cfg.embedding_dim, device=device))
        self.readout = (
            nn.Linear(cfg.hidden_dim, 1, device=device) if cfg.readout_type == "attention" else None
        )

    def _draw(self, generator: torch.Generator | None) -> None:
        if self.item_embedding.device.type != "meta":
            if generator is None:
                generator = torch.Generator(self.item_embedding.device).manual_seed(0)
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from `generator`; BatchNorm starts at identity."""
        init_item_embedding(self.item_embedding, self.config.num_items, generator)
        if self.readout is not None:
            init_xavier_linear(self.readout, generator)
        self._reset_layers(generator)

    def _reset_layers(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    @property
    def uses_laplacian_pe(self) -> bool:
        return bool(getattr(self.config, "use_laplacian_pe", False))

    def precompute_pe(self, item_i, item_j) -> None:
        """Fill the positional encodings from the co-occurrence graph; nothing
        for a model without them."""

    def _rate_and_seed(self, seed):
        """The dropout rate of this mode and the step seed (0 when omitted)."""
        return (self.config.dropout if self.training else 0.0), (0 if seed is None else seed)

    def _nodes(self, batch: SessionBatch, node_embeddings: torch.Tensor | None) -> torch.Tensor:
        """[B, N, D] node features: `node_embeddings` (the sparse step's gathered
        rows) or the table's rows of ``batch.node_ids``."""
        return self.item_embedding[batch.node_ids] if node_embeddings is None else node_embeddings

    def _pool(self, x: torch.Tensor, batch: SessionBatch) -> torch.Tensor:
        return apply_readout(self.readout, x, batch.node_mask, batch.num_nodes, self.config.readout_type)
