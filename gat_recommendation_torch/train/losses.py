"""Ranking losses as pure functions with a uniform (loss, aux) contract.

BPR, Listwise (softmax cross-entropy with the target at index 0 and a
temperature), Dual (alpha*listwise + (1-alpha)*bpr) and SampledSoftmax (an
alias of Listwise). Every loss returns ``(scalar, aux_dict)`` and is masked
over `sample_mask`, so bucket-padding samples contribute nothing.

Each loss has an embedding-direct twin (``*_emb``) that takes the positive and
negative embeddings instead of gathering them from the table: the sparse
train step gathers every row once up front, so the dense table gradient never
materializes. ``fn.from_embeddings`` is that twin.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _masked_mean(per_sample: torch.Tensor, sample_mask: torch.Tensor | None) -> torch.Tensor:
    if sample_mask is None:
        return per_sample.mean()
    m = sample_mask.to(per_sample.dtype)
    return (per_sample * m).sum() / m.sum().clamp_min(1.0)


def _scores_emb(session_emb, target_emb, neg_emb):
    """(pos [B], neg [B, K]) dot-product scores."""
    pos = (session_emb * target_emb).sum(dim=-1)
    neg = torch.einsum("bkd,bd->bk", neg_emb, session_emb)
    return pos, neg


def _gather(item_table, targets, negatives):
    return item_table[targets], item_table[negatives]


def bpr_loss_emb(session_emb, target_emb, neg_emb, sample_mask=None):
    """-log(sigmoid(pos - neg) + 1e-8), mean over samples x negatives."""
    pos, neg = _scores_emb(session_emb, target_emb, neg_emb)
    per = -torch.log(torch.sigmoid(pos[:, None] - neg) + 1e-8)
    loss = _masked_mean(per.mean(dim=1), sample_mask)
    return loss, {"bpr": loss}


def listwise_loss_emb(session_emb, target_emb, neg_emb, sample_mask=None, temperature=1.0):
    """Softmax CE over [pos | negs] with target index 0."""
    pos, neg = _scores_emb(session_emb, target_emb, neg_emb)
    logits = torch.cat([pos[:, None], neg], dim=1) / temperature
    per = -F.log_softmax(logits, dim=1)[:, 0]
    loss = _masked_mean(per, sample_mask)
    return loss, {"listwise": loss}


def dual_loss_emb(session_emb, target_emb, neg_emb, sample_mask=None, alpha=0.7, temperature=1.0):
    """alpha * listwise + (1 - alpha) * bpr; aux carries the components."""
    lw, _ = listwise_loss_emb(session_emb, target_emb, neg_emb, sample_mask, temperature)
    bp, _ = bpr_loss_emb(session_emb, target_emb, neg_emb, sample_mask)
    total = alpha * lw + (1.0 - alpha) * bp
    return total, {"total": total, "listwise": lw, "bpr": bp}


def bpr_loss(session_emb, targets, negatives, item_table, sample_mask=None):
    return bpr_loss_emb(session_emb, *_gather(item_table, targets, negatives), sample_mask)


def listwise_loss(session_emb, targets, negatives, item_table, sample_mask=None, temperature=1.0):
    return listwise_loss_emb(
        session_emb, *_gather(item_table, targets, negatives), sample_mask, temperature
    )


def dual_loss(
    session_emb, targets, negatives, item_table, sample_mask=None, alpha=0.7, temperature=1.0
):
    return dual_loss_emb(
        session_emb, *_gather(item_table, targets, negatives), sample_mask, alpha, temperature
    )


def sampled_softmax_loss(
    session_emb, targets, negatives, item_table, sample_mask=None, temperature=1.0
):
    """Alias of listwise."""
    return listwise_loss(session_emb, targets, negatives, item_table, sample_mask, temperature)


LossFn = Callable  # (sess_emb, targets, negatives, item_table, sample_mask) -> (loss, aux)


def create_loss_function(loss_type: str = "dual", alpha: float = 0.7, temperature: float = 1.0) -> LossFn:
    """Loss factory; raises on an unknown type. The returned function carries
    ``.from_embeddings(sess, target_emb, neg_emb, mask)``, the same loss on
    pre-gathered embeddings."""
    if loss_type == "bpr":
        fn_emb = bpr_loss_emb
    elif loss_type in ("listwise", "sampled_softmax"):
        fn_emb = lambda s, te, ne, m=None: listwise_loss_emb(s, te, ne, m, temperature)  # noqa: E731
    elif loss_type == "dual":
        fn_emb = lambda s, te, ne, m=None: dual_loss_emb(s, te, ne, m, alpha, temperature)  # noqa: E731
    else:
        raise ValueError(f"Unknown loss type: {loss_type}")

    def fn(s, t, n, e, m=None):
        return fn_emb(s, *_gather(e, t, n), m)

    fn.from_embeddings = fn_emb
    return fn


# the module-level losses carry their twins too
bpr_loss.from_embeddings = bpr_loss_emb
dual_loss.from_embeddings = dual_loss_emb
listwise_loss.from_embeddings = listwise_loss_emb
sampled_softmax_loss.from_embeddings = listwise_loss_emb
