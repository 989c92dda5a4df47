"""Shared model pieces: initializers, the padded item table, session readout,
masked BatchNorm, ``SessionModel`` (the base of every model of the registry),
the full-catalog ``predict_topk`` and the BPR loss on embeddings.

Linear layers are ``nn.Linear`` (weight ``[out, in]``, apply ``x @ W.T + b``);
the JAX package stores ``w`` as ``[in, out]`` and ``convert.py`` transposes.
Initial values follow the JAX package's distributions, drawn from an
explicit CPU ``torch.Generator`` and copied onto the model's device, so one
seed gives the same weights on every device, as one JAX key does on every
backend (the numbers differ from JAX's for one seed).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from gat_recommendation_torch.data.batching import SessionBatch
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.ops import shard
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


# A table not drawn in place (one off the CPU, or a row shard) is drawn in
# chunks of whole rows of about this many bytes, into one reused host buffer.
DRAW_CHUNK_BYTES = 64 << 20


def check_cpu_generator(generator: torch.Generator) -> None:
    """Weights come from a CPU generator: a CUDA generator draws another
    stream than a CPU one, so the weights would depend on the device."""
    if generator.device.type != "cpu":
        raise ValueError(
            f"weights are drawn from a CPU torch.Generator (then copied to the model's device), so that "
            f"one seed gives the same weights on every device; got a generator on {generator.device}")


@torch.no_grad()
def draw_uniform_(tensor: torch.Tensor, low: float, high: float, generator: torch.Generator) -> None:
    """Fill `tensor` with U(low, high) from the CPU `generator`. A CPU tensor
    is drawn in place; any other gets a host tensor of its shape and strides,
    drawn the same way and copied over, so the bits do not depend on the
    device. Nothing is drawn on the "meta" device."""
    check_cpu_generator(generator)
    if tensor.device.type == "meta":
        return
    if tensor.device.type == "cpu":
        tensor.uniform_(low, high, generator=generator)
    else:
        tensor.copy_(torch.empty_like(tensor, device="cpu").uniform_(low, high, generator=generator))


@torch.no_grad()
def draw_rows_uniform_(
    table: torch.Tensor, low: float, high: float, generator: torch.Generator,
    total_rows: int | None = None, first_row: int = 0,
) -> None:
    """Fill the [rows, D] `table`, which holds rows ``[first_row, first_row +
    rows)`` of a [total_rows, D] draw of U(low, high) from the CPU
    `generator`: the whole draw is made, so the generator ends where one draw
    of the whole leaves it. A CPU table that is the whole is drawn in place;
    otherwise the draw goes in chunks of whole rows (about DRAW_CHUNK_BYTES),
    in order, into one reused host buffer (pinned for a card), and each
    chunk's rows that `table` holds are copied over. Chunks of whole rows in
    order consume the generator as one draw does, so the bits are those of
    the one-piece draw."""
    check_cpu_generator(generator)
    rows, dim = table.shape
    total_rows = rows if total_rows is None else total_rows
    if table.device.type == "meta":
        return
    if table.device.type == "cpu" and (first_row, total_rows) == (0, rows):
        table.uniform_(low, high, generator=generator)
        return
    chunk_rows = min(max(1, DRAW_CHUNK_BYTES // max(1, dim * table.element_size())), total_rows)
    buffer = torch.empty(chunk_rows, dim, dtype=table.dtype, pin_memory=table.device.type == "cuda")
    for lo in range(0, total_rows, chunk_rows):
        n = min(chunk_rows, total_rows - lo)
        drawn = buffer[:n].uniform_(low, high, generator=generator)
        a, b = max(lo, first_row), min(lo + n, first_row + rows)
        if a < b:
            table[a - first_row:b - first_row].copy_(drawn[a - lo:b - lo])


@torch.no_grad()
def init_torch_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch.nn.Linear default init: weight and bias ~ U(±1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(layer.in_features) if layer.in_features > 0 else 0.0
    draw_uniform_(layer.weight, -bound, bound, generator)
    if layer.bias is not None:
        draw_uniform_(layer.bias, -bound, bound, generator)


@torch.no_grad()
def init_xavier_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """xavier_uniform weight + zero bias (attention readout, LapPE projection)."""
    a = math.sqrt(6.0 / (layer.in_features + layer.out_features))
    draw_uniform_(layer.weight, -a, a, generator)
    if layer.bias is not None:
        layer.bias.zero_()


@torch.no_grad()
def init_glorot(tensor: torch.Tensor, generator: torch.Generator) -> None:
    """PyG glorot: U(±sqrt(6 / (size(-2) + size(-1)))); symmetric in the two
    sizes, so an ``nn.Linear`` weight ``[out, in]`` draws from the bound of
    the JAX package's ``[in, out]``."""
    a = math.sqrt(6.0 / (tensor.shape[-2] + tensor.shape[-1]))
    draw_uniform_(tensor, -a, a, generator)


@torch.no_grad()
def init_item_embedding(
    table: torch.Tensor, num_items: int, generator: torch.Generator, first_row: int = 0,
    total_rows: int | None = None,
) -> None:
    """Fill the [padded(num_items), D] table in place: row 0 (padding) zero,
    rows 1:num_items xavier_uniform with a = sqrt(6 / (num_items - 1 + D)),
    phantom tail rows zero. A row shard passes its `first_row` and the whole
    table's `total_rows`, and takes its rows of the whole table's draw."""
    a = math.sqrt(6.0 / (num_items - 1 + table.shape[1]))
    draw_rows_uniform_(table, -a, a, generator, total_rows, first_row)
    if first_row == 0:
        table[0] = 0.0
    table[max(num_items - first_row, 0):] = 0.0


def mask_phantom(scores: torch.Tensor, num_items: int | None) -> torch.Tensor:
    """-inf the padded phantom columns beyond the logical catalog size."""
    if num_items is None or scores.shape[-1] <= num_items:
        return scores
    col = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(col < num_items, scores, torch.full_like(scores, -math.inf))


def predict_topk(
    session_embeddings: torch.Tensor,
    item_embeddings: torch.Tensor,
    k: int = 20,
    num_items: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-catalog dot-product scores and the exact top-k
    (``ops/scoring.full_catalog_topk``: kernel 2 on the card). Seen items are
    not masked (serving masks them); `num_items` masks the phantom tail.
    Returns (top_k_indices [B, k], top_k_scores [B, k])."""
    from gat_recommendation_torch.ops.scoring import full_catalog_topk

    top_scores, top_idx = full_catalog_topk(session_embeddings, item_embeddings, k, num_items)
    return top_idx, top_scores


def bpr_loss_from_embeddings(
    session_embeddings: torch.Tensor,
    target_emb: torch.Tensor,
    negative_emb: torch.Tensor,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """BPR: -log(sigmoid(pos - neg) + 1e-8), the mean over the (valid)
    samples times their K negatives. target_emb [B, D], negative_emb [B, K, D]."""
    pos = (session_embeddings * target_emb).sum(dim=-1)
    neg = torch.einsum("bkd,bd->bk", negative_emb, session_embeddings)
    per = -torch.log(F.sigmoid(pos[:, None] - neg) + 1e-8)
    if sample_mask is None:
        return per.mean()
    m = sample_mask.to(per.dtype)[:, None]
    return (per * m).sum() / (m.sum() * per.shape[1]).clamp_min(1.0)


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
    `generator`, a CPU ``torch.Generator`` (seed 0 when omitted; one on
    another device raises): the draws are made on the host and copied, so the
    weights do not depend on the device.
    On the "meta" device nothing is drawn: load real tensors with
    ``load_state_dict(..., assign=True)``, as the serving checkpoint loader does.

    Under a mesh (``parallel/mesh.py::shard_model``) the table, and whatever
    is shaped like it, holds rows ``[table_offset, table_offset + rows)`` of
    the whole: drawing and the positional encodings fill those rows of what
    one GPU would hold, and lookups go through ``ops/shard.py::lookup``.
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
        self.table_offset = 0  # the global row of the table's row 0 (a row shard's first row)
        self.readout = (
            nn.Linear(cfg.hidden_dim, 1, device=device) if cfg.readout_type == "attention" else None
        )

    def _draw(self, generator: torch.Generator | None) -> None:
        if self.item_embedding.device.type != "meta":
            self.reset_parameters(torch.Generator().manual_seed(0) if generator is None else generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from the CPU `generator`; BatchNorm starts at
        identity. A row shard of the table takes its rows of the whole table's
        draw (drawn on the host in chunks, only its rows copied over), so every
        rank draws what one GPU draws."""
        init_item_embedding(self.item_embedding, self.config.num_items, generator, self.table_offset,
                            padded_rows(self.config.num_items))
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
        return shard.lookup(self.item_embedding, batch.node_ids) if node_embeddings is None else node_embeddings

    def _pool(self, x: torch.Tensor, batch: SessionBatch) -> torch.Tensor:
        return apply_readout(self.readout, x, batch.node_mask, batch.num_nodes, self.config.readout_type)
