"""Masked dense primitives (softmax / mean / max / batch-norm under padding).

The per-destination segment softmax over incoming edges becomes a row-masked
softmax over the dense adjacency axis, and rows with no valid entries produce
exact zeros — scatter-sum-of-nothing for isolated nodes. Masked entries are
filled with -1e30 (not -inf) and a row whose max is still below -5e29 is
treated as all-masked, exactly as in the JAX package.
"""

from __future__ import annotations

import torch

from gat_recommendation_torch.ops.rounding import keep_mask, keep_scale

_NEG_INF = -1e30


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` restricted to mask; all-masked rows -> zeros."""
    neg = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = neg.amax(dim=dim, keepdim=True)
    # Guard all-masked rows so exp doesn't overflow after subtracting -1e30.
    m = torch.where(m <= _NEG_INF / 2, torch.zeros_like(m), m)
    e = torch.exp(neg - m) * mask.to(scores.dtype)
    denom = e.sum(dim=dim, keepdim=True)
    return e / denom.clamp_min(1e-16)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Mean of x over `dim` counting only masked entries (empty -> 0)."""
    m = mask.to(x.dtype).unsqueeze(-1)
    total = (x * m).sum(dim=dim)
    count = m.sum(dim=dim)
    return total / count.clamp_min(1.0)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Max of x over `dim` among masked entries (empty -> 0)."""
    m = mask.unsqueeze(-1)
    out = torch.where(m, x, torch.full_like(x, _NEG_INF)).amax(dim=dim)
    any_valid = mask.any(dim=dim, keepdim=True)
    return torch.where(any_valid, out, torch.zeros_like(out))


def masked_batch_norm(
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    count: torch.Tensor,
    x: torch.Tensor,
    mask: torch.Tensor,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> torch.Tensor:
    """BatchNorm over the flattened node axis, counting only valid nodes.

    torch.nn.BatchNorm1d semantics on the ragged [num_nodes, D] node tensor:
    normalization uses the biased batch variance; the running statistics are
    EMA-updated with the unbiased variance. In train mode the running
    `running_mean`, `running_var` and `count` buffers are updated IN PLACE
    (the JAX package returns a new state instead).

    x: [B, N, D]; mask: [B, N]. Returns the normalized x.
    """
    if train:
        m = mask.to(x.dtype).unsqueeze(-1)
        n = m.sum().clamp_min(1.0)
        mean = (x * m).sum(dim=(0, 1)) / n
        var = ((x - mean).square() * m).sum(dim=(0, 1)) / n
        unbiased = var * n / (n - 1.0).clamp_min(1.0)
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(momentum * mean)
            running_var.mul_(1 - momentum).add_(momentum * unbiased)
            count.add_(n)
    else:
        mean, var = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * scale + bias


def dropout(x: torch.Tensor, rate: float, train: bool, seed: int | torch.Tensor = 0) -> torch.Tensor:
    """Inverted dropout (kept entries scaled by ``keep_scale(rate)``, 1/(1-rate)
    in float32, at train time).

    The keep mask is a pure function of `seed` and each element's linear
    index (``rounding.keep_mask``, the counter hash of the attention
    dropout). `seed` is an int or a 0-dim int64 tensor holding its bits. The
    plain version of ``ops/node_dropout.py``'s kernel, which the model calls."""
    if not train or rate <= 0.0:
        return x
    keep = keep_mask(x.shape, rate, seed, x.device)
    return torch.where(keep, x * keep_scale(rate), torch.zeros_like(x))
