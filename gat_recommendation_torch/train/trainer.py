"""Train and eval steps, and the Trainer's epoch and evaluation loops.

The steps update the model and the optimizer state IN PLACE (the JAX package
threads ``params, state, opt_state`` through pure functions): a step is
``step(batch, seed) -> loss`` with the loss left on the device. The model's
BatchNorm buffers move during the forward, the table and its moments inside
the fused AdamW pass, the other parameters inside ``torch.optim.AdamW``.

Per-step randomness is explicit: the Trainer derives a 64-bit step seed on
the host from ``(seed, epoch, step)`` and the model splits it per layer into
the attention-dropout seed and the seed of the node-dropout generator.

Not ported yet (ROADMAP.md, queue A): chained steps (``chain > 1``), the lazy
optimizer, ``Trainer.train()`` with its best/latest checkpoints, early stop
and resume.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from gat_recommendation_torch.data.batching import (
    SessionBatch,
    make_grad_index,
    to_device,
)
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.ops.rounding import mix_seed
from gat_recommendation_torch.ops.scoring import full_catalog_topk
from gat_recommendation_torch.train.losses import bpr_loss
from gat_recommendation_torch.train.metrics import compute_ndcg_at_k, compute_recall_at_k
from gat_recommendation_torch.train.optimizers import (
    EMBEDDING_KEY,
    FusedEmbeddingAdamW,
    rest_parameters,
)


def sorted_segment_sum(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum consecutive runs of `rows` ([R, D]); run u has ``lengths[u]`` rows
    (0 gives a zero row). Each output row is summed in slot order by one
    reduction, so the result does not change from run to run; ``index_add_``
    on the card adds atomically in no fixed order."""
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)


def make_train_step(model: nn.Module, loss_fn, optimizer, opt_state: dict) -> Callable:
    """The dense-gradient training step: ``step(batch, seed) -> loss``.

    Forward in train mode, the loss gathering targets and negatives from the
    table, gradients of every parameter (the table's as a dense [V, D]
    tensor), row 0 of the table gradient zeroed (the padding item never
    updates), then ``optimizer.update_full``.
    """

    def train_step(batch: SessionBatch, seed: int = 0) -> torch.Tensor:
        model.train()
        params = dict(model.named_parameters())
        sess = model(batch, seed=seed)
        loss, _aux = loss_fn(
            sess, batch.targets, batch.negatives, params[EMBEDDING_KEY], batch.sample_mask
        )
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
        grads[EMBEDDING_KEY][0] = 0.0
        optimizer.update_full(grads, opt_state, model)
        return loss.detach()

    return train_step


def make_sparse_train_step(model: nn.Module, loss_fn, optimizer, opt_state: dict) -> Callable:
    """The training step with sparse embedding gradients: ``step(batch, seed) -> loss``.

    All embedding rows the step touches (session nodes, targets, negatives)
    are gathered ONCE up front and the loss is differentiated with respect to
    those rows, so the dense [V, D] table gradient never materializes.
    Duplicate rows are reduced with the host-sorted ``GradIndex``
    (AdamW's second moment needs (sum g)^2, not sum g^2) by a deterministic
    sorted segment sum; the row of id 0 is zeroed (the padding item never
    updates); ``optimizer.update_sparse`` does the rest.

    `batch` is a ``SessionBatch`` (the index is built on the fly from a copy
    on the host: convenient for tests) or a ``(SessionBatch, GradIndex)``
    pair already on the model's device (the Trainer's path). The loss needs
    ``.from_embeddings`` (all built-in losses have it).
    """
    if not hasattr(optimizer, "update_sparse"):
        raise TypeError("optimizer must support update_sparse")

    def train_step(batch, seed: int = 0) -> torch.Tensor:
        model.train()
        if isinstance(batch, tuple):
            batch, gidx = batch
        else:
            gidx = to_device(make_grad_index(batch.to("cpu")), batch.node_ids.device)
        B, N = batch.node_ids.shape
        K = batch.negatives.shape[1]
        table = model.get_parameter(EMBEDDING_KEY)
        rows = table.detach()[gidx.ids].requires_grad_(True)
        node_emb = rows[: B * N].view(B, N, -1)
        target_emb = rows[B * N : B * N + B]
        neg_emb = rows[B * N + B :].view(B, K, -1)
        sess = model(batch, node_embeddings=node_emb, seed=seed)
        loss, _aux = loss_fn.from_embeddings(sess, target_emb, neg_emb, batch.sample_mask)

        other = rest_parameters(model)
        *g_other, g_rows = torch.autograd.grad(loss, [*other.values(), rows], allow_unused=True)
        summed = sorted_segment_sum(g_rows[gidx.perm], gidx.lengths)
        summed = summed * (gidx.uid != 0)[:, None]
        optimizer.update_sparse(dict(zip(other, g_other)), gidx.uid, summed, opt_state, model)
        return loss.detach()

    return train_step


def make_eval_step(model: nn.Module, k: int, topk_method: str = "auto") -> Callable:
    """``step(batch) -> top-k item ids [B, k]`` (eval-mode forward, then
    full-catalog scoring). 'auto' is the exact two-level selector over the
    score and chunk-max kernel; 'dense' is the one-sort oracle."""

    @torch.no_grad()
    def eval_step(batch: SessionBatch) -> torch.Tensor:
        model.eval()
        sess = model(batch)
        _, top_idx = full_catalog_topk(
            sess, model.get_parameter(EMBEDDING_KEY), k, model.config.num_items, method=topk_method
        )
        return top_idx

    return eval_step


class Trainer:
    """Epoch loop over bucketed SessionBatch streams.

    `train_batches(epoch)` and `val_batches()` return iterators of host
    batches (``data.batching.iterate_batches``). The model must already be on
    `device` (``cuda`` when None, which raises without a CUDA device).
    Without an `optimizer`, ``FusedEmbeddingAdamW(1e-3, weight_decay=1e-5)``.
    ``sparse_embedding_grads`` chooses the sparse step over the dense one.
    """

    def __init__(
        self,
        model: nn.Module,
        train_batches: Callable[[int], Iterable],
        val_batches: Callable[[], Iterable],
        optimizer=None,
        k_values: list[int] | None = None,
        loss_fn=None,
        seed: int = 42,
        sparse_embedding_grads: bool = False,
        chain: int = 1,
        device=None,
    ):
        if chain != 1:
            raise NotImplementedError(
                "chained train steps are not ported yet (ROADMAP.md, queue A item 2b); use chain=1"
            )
        self.device = resolve_device(device)
        table = model.get_parameter(EMBEDDING_KEY)
        if table.device.type != self.device.type:
            raise ValueError(f"the model is on {table.device}, the Trainer on {self.device}")
        self.model = model
        self.train_batches = train_batches
        self.val_batches = val_batches
        self.sparse_embedding_grads = sparse_embedding_grads
        self.optimizer = optimizer or FusedEmbeddingAdamW(1e-3, weight_decay=1e-5)
        self.k_values = k_values if k_values is not None else [10, 20]
        self.loss_fn = loss_fn or bpr_loss
        self.seed = seed
        self.chain = 1
        self.current_epoch = 0
        self.opt_state: dict | None = None
        self._train_step: Callable | None = None
        self._eval_step = make_eval_step(self.model, max(self.k_values))

    def init_state(self, reset_parameters: bool = True, opt_state: dict | None = None) -> dict:
        """Fresh optimizer state (or `opt_state`, to go on from it), and, unless
        `reset_parameters` is False (e.g. after loading weights), parameters
        drawn anew from the Trainer's seed. Builds the train step over that
        state and returns the state."""
        if reset_parameters:
            self.model.reset_parameters(torch.Generator(self.device).manual_seed(self.seed))
        self.opt_state = self.optimizer.init(self.model) if opt_state is None else opt_state
        make = make_sparse_train_step if self.sparse_embedding_grads else make_train_step
        self._train_step = make(self.model, self.loss_fn, self.optimizer, self.opt_state)
        return self.opt_state

    def _transfer(self, batch: SessionBatch):
        """One host batch to the device; for the sparse step the GradIndex is
        built on the host (numpy argsort) beside it."""
        if not self.sparse_embedding_grads:
            return to_device(batch, self.device)
        return to_device((batch, make_grad_index(batch)), self.device)

    def step_seed(self, step: int) -> int:
        return mix_seed(self.seed, self.current_epoch, step)

    def train_epoch(self) -> float:
        """One epoch over ``train_batches(current_epoch)``; returns the mean
        loss. Losses stay on the device until the epoch ends: a readback per
        step would make the host wait for the card every step."""
        if self._train_step is None:
            self.init_state(reset_parameters=False)
        losses = []
        for step, batch in enumerate(self.train_batches(self.current_epoch)):
            losses.append(self._train_step(self._transfer(batch), self.step_seed(step)))
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())  # the epoch's one readback

    def evaluate(self) -> dict:
        """recall@k and ndcg@k over ``val_batches()``. Per-batch top-k stays
        on the device; one concatenated readback at the end."""
        device_tops, masks, targets = [], [], []
        for batch in self.val_batches():
            device_tops.append(self._eval_step(to_device(batch, self.device)))
            masks.append(np.asarray(batch.sample_mask))
            targets.append(np.asarray(batch.targets))
        if not device_tops:
            predictions = np.zeros((0, max(self.k_values)), int)
            targets_arr = np.zeros((0,), int)
        else:
            all_tops = torch.cat(device_tops, dim=0).cpu().numpy()
            mask = np.concatenate(masks)
            predictions = all_tops[mask]
            targets_arr = np.concatenate(targets)[mask]
        metrics = {}
        for k in self.k_values:
            metrics[f"recall@{k}"] = compute_recall_at_k(predictions, targets_arr, k)
            metrics[f"ndcg@{k}"] = compute_ndcg_at_k(predictions, targets_arr, k)
        return metrics

