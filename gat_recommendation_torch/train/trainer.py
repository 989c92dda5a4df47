"""Train and eval steps, and the Trainer: epochs, evaluation, checkpoints,
early stop and resume.

The steps update the model and the optimizer state IN PLACE (the JAX package
threads ``params, state, opt_state`` through pure functions): a step is
``step(batch, seed) -> loss`` with the loss left on the device. The model's
BatchNorm buffers move during the forward, the table and its moments inside
the fused AdamW pass, the other parameters inside ``torch.optim.AdamW``.

Per-step randomness is explicit: the Trainer derives a 64-bit step seed on
the host from ``(seed, epoch, step)``. A step puts it, with the step count and
what derives from the count, into a row of the step block
(``ops/step_block.py``) on the device, one copy a step, where the model's
layers and the kernels read their seeds and the AdamW kernels their count,
bias corrections and rounding seeds.

With ``chain > 1`` (sparse steps) the Trainer groups the epoch's batches of one
node bucket by ``chain`` (``data/batching.chain_iterator``) and runs each
full group as one chained step over the stacked batches; a partial group at a
bucket boundary runs as chains of ``SUBCHAIN`` steps and single steps. On the
card a chained step replays CUDA graphs (``train/graphs.py``); on the CPU it
is a loop over the slots. Either way it is the program of the unchained loop,
step for step and seed for seed: a chained run equals an unchained one bit for
bit. Evaluation chains the same way.

``Trainer.train()`` runs the JAX package's training policy: evaluation every
``eval_every`` epochs on recall/NDCG at ``k_values``, early stop on
recall@``k_values[0]`` after ``patience`` evaluations without a gain, the best
state kept on the device and written once at the end (``defer_best``),
``checkpoint_latest`` every ``checkpoint_every`` evaluations plus a backstop
save of the last epoch, ``history.json``, and resume from
``checkpoint_latest``. The lazy optimizer is materialized before every
evaluation (which the save after it shares) and before the backstop save, so
checkpoints hold the dense-trajectory table. Checkpoints are
``train/checkpoint.py``'s format with the optimizer file.

An epoch's host work (batch assembly, the sparse step's ``GradIndex``,
stacking a group, the copies to the device) runs ahead of the steps on a
background thread (``data/batching.prefetch_to_device``, two items ahead,
``transfer_workers`` threads for the transfers), on the card through a side
stream; the step seeds and the step block stay on the thread that launches
the steps, so the epoch is the inline one, bit for bit. ``evaluate`` transfers
inline.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from gat_recommendation_torch.data.batching import (
    GradIndex,
    SessionBatch,
    chain_iterator,
    make_grad_index,
    prefetch_to_device,
    stack_batches,
    stack_grad_indices,
    to_device,
)
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.ops.rounding import mix_seed
from gat_recommendation_torch.ops.scoring import full_catalog_topk
from gat_recommendation_torch.ops import step_block
from gat_recommendation_torch.train import checkpoint
from gat_recommendation_torch.train.graphs import GraphCache
from gat_recommendation_torch.train.hits_io import load_hits, save_hits
from gat_recommendation_torch.train.losses import bpr_loss
from gat_recommendation_torch.train.metrics import compute_ndcg_at_k, compute_recall_at_k
from gat_recommendation_torch.train.optimizers import (
    EMBEDDING_KEY,
    FusedEmbeddingAdamW,
    rest_parameters,
)

logger = logging.getLogger(__name__)


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
    updates), then ``optimizer.update_full``. The step's count and seeds reach
    the model and the kernels as a one-row step block.
    """

    def train_step(batch: SessionBatch, seed: int = 0) -> torch.Tensor:
        model.train()
        params = dict(model.named_parameters())
        row = next_steps_block(model, optimizer, opt_state, [seed], batch.node_ids.device)[0]
        sess = model(batch, seed=row)
        loss, _aux = loss_fn(
            sess, batch.targets, batch.negatives, params[EMBEDDING_KEY], batch.sample_mask
        )
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
        grads[EMBEDDING_KEY][0] = 0.0
        optimizer.update_full(grads, opt_state, model, step=row)
        return loss.detach()

    return train_step


def next_steps_block(model: nn.Module, optimizer, opt_state: dict, step_seeds, device) -> torch.Tensor:
    """The step block of the next ``len(step_seeds)`` steps of
    `optimizer` over `model` (counts from ``opt_state["count"] + 1``), on
    `device`."""
    return step_block.build(opt_state["count"], step_seeds, b1=optimizer.b1, b2=optimizer.b2,
                            num_layers=model.config.num_layers, seeds_per_layer=model.seeds_per_layer,
                            device=device)


def make_sparse_train_step(model: nn.Module, loss_fn, optimizer, opt_state: dict) -> Callable:
    """The training step with sparse embedding gradients: ``step(batch, seed) -> loss``.

    All embedding rows the step touches (session nodes, targets, negatives)
    are gathered ONCE up front and the loss is differentiated with respect to
    those rows, so the dense [V, D] table gradient never materializes.
    Duplicate rows are reduced with the host-sorted ``GradIndex``
    (AdamW's second moment needs (sum g)^2, not sum g^2) by a deterministic
    sorted segment sum; the row of id 0 is zeroed (the padding item never
    updates); ``optimizer.update_sparse`` does the rest.

    With a lazy optimizer the rows come from ``optimizer.gather_catch_up``:
    each unique row once, caught up to the dense trajectory, then spread to
    the R slots through the inverse of the host-sorted permutation; the
    summed gradient goes to ``optimizer.update_sparse_lazy``.

    `batch` is a ``SessionBatch`` (the index is built on the fly from a copy
    on the host: convenient for tests) or a ``(SessionBatch, GradIndex)``
    pair already on the model's device (the Trainer's path). The loss needs
    ``.from_embeddings`` (all built-in losses have it). The step's count and
    seeds reach the model and the kernels as a one-row step block.
    """
    body = _sparse_step_body(model, loss_fn, optimizer, opt_state)

    def train_step(batch, seed: int = 0) -> torch.Tensor:
        if isinstance(batch, tuple):
            batch, gidx = batch
        else:
            gidx = to_device(make_grad_index(batch.to("cpu")), batch.node_ids.device)
        device = batch.node_ids.device
        return body(batch, gidx, next_steps_block(model, optimizer, opt_state, [seed], device)[0])

    return train_step


def _sparse_step_body(model: nn.Module, loss_fn, optimizer, opt_state: dict) -> Callable:
    """``body(batch, gidx, row) -> loss``: one sparse step on device tensors,
    `row` the step's row of the step block. Shared by the single step and the
    chained one, whose graphs capture it."""
    if not hasattr(optimizer, "update_sparse"):
        raise TypeError("optimizer must support update_sparse")
    lazy = getattr(optimizer, "lazy", False)

    def body(batch: SessionBatch, gidx: GradIndex, row: torch.Tensor) -> torch.Tensor:
        model.train()
        B, N = batch.node_ids.shape
        K = batch.negatives.shape[1]
        if lazy:
            w_c, mu_c, nu_c = optimizer.gather_catch_up(model, opt_state, gidx.uid, step=row)
            u_of_r = torch.empty_like(gidx.perm)  # perm is a permutation: every slot is set once
            u_of_r[gidx.perm] = gidx.seg
            rows = w_c[u_of_r].requires_grad_(True)
        else:
            rows = model.get_parameter(EMBEDDING_KEY).detach()[gidx.ids].requires_grad_(True)
        node_emb = rows[: B * N].view(B, N, -1)
        target_emb = rows[B * N : B * N + B]
        neg_emb = rows[B * N + B :].view(B, K, -1)
        sess = model(batch, node_embeddings=node_emb, seed=row)
        loss, _aux = loss_fn.from_embeddings(sess, target_emb, neg_emb, batch.sample_mask)

        other = rest_parameters(model)
        *g_other, g_rows = torch.autograd.grad(loss, [*other.values(), rows], allow_unused=True)
        summed = sorted_segment_sum(g_rows[gidx.perm], gidx.lengths)
        summed = summed * (gidx.uid != 0)[:, None]
        g_rest = dict(zip(other, g_other))
        if lazy:
            optimizer.update_sparse_lazy(g_rest, gidx.uid, summed, w_c, mu_c, nu_c, opt_state, model,
                                         step=row)
        else:
            optimizer.update_sparse(g_rest, gidx.uid, summed, opt_state, model, step=row)
        return loss.detach()

    return body


def _fields(item) -> list[torch.Tensor]:
    """The tensors of a SessionBatch or a GradIndex, in field order."""
    if isinstance(item, GradIndex):
        return list(item)
    return [getattr(item, f.name) for f in dataclasses.fields(item)]


def _slot(item, i: int):
    """Slot i of a stacked SessionBatch or GradIndex."""
    return item.map(lambda t: t[i]) if isinstance(item, SessionBatch) else GradIndex(*(t[i] for t in item))


def _train_state(model: nn.Module, opt_state: dict) -> Callable[[], list]:
    """What a sparse step writes in place: parameters, buffers (BatchNorm),
    the table's moments and ``last_step``, the other parameters' AdamW state."""
    def tensors() -> list:
        rest = [t for s in opt_state["rest"].state.values() for t in s.values()]
        table_state = [opt_state[k] for k in ("emb_mu", "emb_nu", "last_step") if k in opt_state]
        return [*model.parameters(), *model.buffers(), *table_state, *rest]

    return tensors


def make_chained_sparse_train_step(model: nn.Module, loss_fn, optimizer, opt_state: dict) -> Callable:
    """C sparse steps in one call: ``chained(batches, gidxs, block) -> losses [C]``.

    `batches` and `gidxs` are a stacked SessionBatch and GradIndex on the
    model's device (``stack_batches`` / ``stack_grad_indices``), `block` the
    C steps' rows of the step block (``next_steps_block``): slot i is the
    step ``make_sparse_train_step`` would take with ``block[i]``'s seed, so
    chained and unchained training are the same program. The losses stay on
    the device.

    On the CPU a loop over the slots. On the card one CUDA graph of a single
    step per (node bucket, unique-row bucket), replayed C times, slot i
    copied into its input buffers before the i-th replay (``train/graphs.py``):
    the graphs do not depend on C, so sub-chains and full groups replay the
    same graph, and a capture costs one warm-up step and one recorded one.
    """
    body = _sparse_step_body(model, loss_fn, optimizer, opt_state)

    if model.get_parameter(EMBEDDING_KEY).device.type != "cuda":
        def run_slots(batches: SessionBatch, gidxs: GradIndex, block: torch.Tensor) -> torch.Tensor:
            return torch.stack([body(_slot(batches, i), _slot(gidxs, i), block[i])
                                for i in range(block.shape[0])])

        return run_slots
    n_batch = len(dataclasses.fields(SessionBatch))
    n_index = len(GradIndex._fields)

    def step(*flat):
        return body(SessionBatch(*flat[:n_batch]), GradIndex(*flat[n_batch:n_batch + n_index]), flat[-1])

    cache = GraphCache(step, _train_state(model, opt_state), opt_state)

    def chained(batches: SessionBatch, gidxs: GradIndex, block: torch.Tensor) -> torch.Tensor:
        flat = [*_fields(batches), *_fields(gidxs), block]
        losses = torch.empty(block.shape[0], device=block.device)
        for i in range(block.shape[0]):
            slot = [t[i] for t in flat]
            losses[i].copy_(cache.run(tuple(t.shape for t in slot), slot))
        opt_state["count"] += block.shape[0]
        return losses

    chained.graphs = cache
    return chained


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


def make_chained_eval_step(model: nn.Module, k: int, topk_method: str = "auto") -> Callable:
    """C eval steps in one call: ``chained_eval(batches) -> top-k ids [C, B, k]``
    over a stacked batch on the model's device, the same selector and outputs
    as ``make_eval_step``. On the CPU a loop over the slots; on the card one
    CUDA graph per (node bucket, C), which reads the table where it lies."""
    eval_step = make_eval_step(model, k, topk_method)

    def run_slots(node_ids, node_mask, adj, num_nodes) -> torch.Tensor:
        batches = SessionBatch(node_ids, node_mask, adj, num_nodes)
        return torch.stack([eval_step(_slot(batches, i)) for i in range(node_ids.shape[0])])

    def forward_fields(batches: SessionBatch) -> list[torch.Tensor]:
        return [batches.node_ids, batches.node_mask, batches.adj, batches.num_nodes]

    if model.get_parameter(EMBEDDING_KEY).device.type != "cuda":
        return lambda batches: run_slots(*forward_fields(batches))
    cache = GraphCache(run_slots)

    def chained_eval(batches: SessionBatch) -> torch.Tensor:
        flat = forward_fields(batches)
        return cache.run(tuple(t.shape for t in flat), flat).clone()

    chained_eval.graphs = cache
    return chained_eval


def _device_copy(tensors: dict) -> dict:
    """A copy of every tensor of a flat dict on its own device (a snapshot
    that the next steps, which update in place, do not touch)."""
    return {k: v.detach().clone() for k, v in tensors.items()}


class Trainer:
    """Epoch-loop trainer over bucketed SessionBatch streams.

    `train_batches(epoch)` and `val_batches()` return iterators of host
    batches (``data.batching.iterate_batches``). The model must already be on
    `device` (``cuda`` when None, which raises without a CUDA device).
    Without an `optimizer`, ``FusedEmbeddingAdamW(1e-3, weight_decay=1e-5)``.
    ``sparse_embedding_grads`` chooses the sparse step over the dense one;
    ``chain`` > 1 runs the sparse steps and the evaluation in chained groups
    of that many batches (the dense step takes no chain, as in the JAX
    package). ``train()`` writes into `output_dir` (created at the first save):
    ``checkpoint_best``, ``checkpoint_latest``, ``history.json`` and, with
    ``record_hits``, ``hits_k{k}.npz``. ``checkpoint_every`` counts
    evaluations: the latest checkpoint is written at every such evaluation,
    at an early stop and at the last epoch. ``defer_best`` keeps the best
    state as a device copy and writes ``checkpoint_best`` once at the end
    (False: at every improvement). ``transfer_workers`` > 1 runs an epoch's
    transfers on that many threads (``prefetch_to_device``).
    """

    def __init__(
        self,
        model: nn.Module,
        train_batches: Callable[[int], Iterable],
        val_batches: Callable[[], Iterable],
        optimizer=None,
        output_dir: str | Path = "outputs",
        max_epochs: int = 100,
        patience: int = 10,
        eval_every: int = 1,
        checkpoint_every: int = 1,
        k_values: list[int] | None = None,
        loss_fn=None,
        seed: int = 42,
        sparse_embedding_grads: bool = False,
        chain: int = 1,
        defer_best: bool = True,
        record_hits: bool = False,
        transfer_workers: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        table = model.get_parameter(EMBEDDING_KEY)
        if table.device.type != self.device.type:
            raise ValueError(f"the model is on {table.device}, the Trainer on {self.device}")
        self.model = model
        self.train_batches = train_batches
        self.val_batches = val_batches
        self.sparse_embedding_grads = sparse_embedding_grads
        self.optimizer = optimizer or FusedEmbeddingAdamW(1e-3, weight_decay=1e-5)
        self.output_dir = Path(output_dir)
        self.max_epochs = max_epochs
        self.patience = patience
        self.eval_every = eval_every
        self.checkpoint_every = checkpoint_every
        self.k_values = k_values if k_values is not None else [10, 20]
        self.loss_fn = loss_fn or bpr_loss
        self.seed = seed
        self.chain = chain if sparse_embedding_grads else 1
        self.defer_best = defer_best
        self.record_hits = record_hits
        self.transfer_workers = transfer_workers
        self.current_epoch = 0
        self.best_val_metric = 0.0
        self.patience_counter = 0
        self.history: dict = {"train_loss": [], "val_metrics": []}
        # Row i of `hits` aligns with history["val_metrics"][i] (None: unknown).
        self.hits: list = []
        # One entry per checkpoint written or read: op, which, epoch, seconds, bytes.
        self.checkpoint_log: list[dict] = []
        # How many chained train and eval dispatches ran: a bucket layout that
        # never fills a group would run single steps only.
        self.chained_dispatches = 0
        self.chained_eval_dispatches = 0
        self._n_evals = 0
        self._latest_saved_epoch: int | None = None
        self._best_snapshot: tuple | None = None
        self.opt_state: dict | None = None
        self._train_step: Callable | None = None
        self._chained_step: Callable | None = None
        self._eval_step = make_eval_step(self.model, max(self.k_values))
        # Its graphs hold only the model's tensors, which keep their identity.
        self._chained_eval = make_chained_eval_step(self.model, max(self.k_values)) if self.chain > 1 else None

    def init_state(self, reset_parameters: bool = True, opt_state: dict | None = None) -> dict:
        """Fresh optimizer state (or `opt_state`, to go on from it), and, unless
        `reset_parameters` is False (e.g. after loading weights), parameters
        drawn anew from the Trainer's seed. Builds the train steps over that
        state (the chained step's graphs, captured over the previous state,
        go with it) and returns the state."""
        if reset_parameters:
            self.model.reset_parameters(torch.Generator(self.device).manual_seed(self.seed))
        self.opt_state = self.optimizer.init(self.model) if opt_state is None else opt_state
        make = make_sparse_train_step if self.sparse_embedding_grads else make_train_step
        self._train_step = make(self.model, self.loss_fn, self.optimizer, self.opt_state)
        if self.chain > 1:
            self._chained_step = make_chained_sparse_train_step(
                self.model, self.loss_fn, self.optimizer, self.opt_state)
        return self.opt_state

    def _transfer(self, batch: SessionBatch):
        """One host batch to the device; for the sparse step the GradIndex is
        built on the host (numpy argsort) beside it."""
        if not self.sparse_embedding_grads:
            return to_device(batch, self.device)
        return to_device((batch, make_grad_index(batch)), self.device)

    # A partial group at a bucket boundary runs as chains of this many steps
    # before single steps, as in the JAX package; they replay the same graphs.
    SUBCHAIN = 8

    def _transfer_chain(self, batches: list) -> list:
        """One ``chain_iterator`` group on the device: a full group is one
        ("chained", batches, gidxs) entry; a partial one splits into SUBCHAIN
        chains and single transferred steps."""
        if len(batches) == self.chain:
            return [self._stack_group(batches)]
        out, i = [], 0
        while len(batches) - i >= self.SUBCHAIN and self.chain > self.SUBCHAIN:
            out.append(self._stack_group(batches[i:i + self.SUBCHAIN]))
            i += self.SUBCHAIN
        out.extend(self._transfer(b) for b in batches[i:])
        return out

    def _stack_group(self, batches: list) -> tuple:
        gidxs = stack_grad_indices([make_grad_index(b) for b in batches])
        return ("chained", *to_device((stack_batches(batches), gidxs), self.device))

    def step_seed(self, step: int) -> int:
        return mix_seed(self.seed, self.current_epoch, step)

    def train_epoch(self) -> float:
        """One epoch over ``train_batches(current_epoch)``; returns the mean
        loss. The batches and their transfers come from a background thread
        two items ahead (``prefetch_to_device``). Losses stay on the device
        until the epoch ends: a readback per step would make the host wait for
        the card every step. With a chain, full groups go through the chained
        step with the step seeds the unchained loop would use."""
        if self._train_step is None:
            self.init_state(reset_parameters=False)
        losses = []
        if self.chain > 1:
            groups = prefetch_to_device(
                chain_iterator(self.train_batches(self.current_epoch), self.chain), size=2,
                transfer=self._transfer_chain, transfer_workers=self.transfer_workers, device=self.device)
            step = 0
            for entries in groups:
                for entry in entries:
                    if isinstance(entry[0], str):  # ("chained", batches, gidxs)
                        _, batches, gidxs = entry
                        seeds = [self.step_seed(step + i) for i in range(gidxs.uid.shape[0])]
                        block = next_steps_block(self.model, self.optimizer, self.opt_state, seeds, self.device)
                        losses.append(self._chained_step(batches, gidxs, block))
                        self.chained_dispatches += 1
                        step += len(seeds)
                    else:
                        losses.append(self._train_step(entry, self.step_seed(step)))
                        step += 1
        else:
            batches = prefetch_to_device(self.train_batches(self.current_epoch), size=2, transfer=self._transfer,
                                         transfer_workers=self.transfer_workers, device=self.device)
            for step, batch in enumerate(batches):
                losses.append(self._train_step(batch, self.step_seed(step)))
        if not losses:
            return 0.0
        return float(torch.cat([loss.reshape(-1) for loss in losses]).mean())  # the epoch's one readback

    def evaluate(self) -> dict:
        """recall@k and ndcg@k over ``val_batches()``, after the lazy
        optimizer's pending row updates are flushed (so the table read is the
        dense trajectory's, as is what a save after it writes). Per-batch
        top-k stays on the device; one concatenated readback at the end."""
        self._materialize()
        device_tops, masks, targets = [], [], []
        # With a chain, full groups of one node bucket are one chained
        # evaluation each; partial groups take single steps. The order stays
        # the batches', so predictions align with targets.
        groups = chain_iterator(self.val_batches(), self.chain) if self.chain > 1 else (
            [batch] for batch in self.val_batches())
        for group in groups:
            if len(group) == self.chain > 1:
                tops = self._chained_eval(to_device(stack_batches(group), self.device))
                device_tops.append(tops.reshape(-1, tops.shape[-1]))
                self.chained_eval_dispatches += 1
            else:
                device_tops.extend(self._eval_step(to_device(batch, self.device)) for batch in group)
            masks.extend(np.asarray(batch.sample_mask) for batch in group)
            targets.extend(np.asarray(batch.targets) for batch in group)
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
        if self.record_hits:
            # Per-session hit vector at k_values[0], in the (fixed) val order.
            k0 = self.k_values[0]
            self.hits.append((predictions[:, :k0] == targets_arr[:, None]).any(axis=1).astype(np.int8))
        return metrics

    def _materialize(self) -> None:
        """Flush the lazy optimizer's pending row updates (a no-op otherwise)."""
        if self.opt_state is not None:
            self.optimizer.materialize(self.model, self.opt_state)

    # -- checkpoints --------------------------------------------------------

    @property
    def _hits_path(self) -> Path:
        return self.output_dir / f"hits_k{self.k_values[0]}.npz"

    def _save_hits(self) -> None:
        """The hit vectors, padded at the front to the evaluations in the
        history, so that row i always aligns with history["val_metrics"][i]."""
        n = len(self.history["val_metrics"])
        save_hits(self._hits_path, [None] * (n - len(self.hits)) + list(self.hits))

    def _log_checkpoint(self, op: str, which: str, epoch: int, seconds: float) -> None:
        path = self.output_dir / f"checkpoint_{which}"
        size = sum(f.stat().st_size for f in path.iterdir())
        self.checkpoint_log.append({"op": op, "which": which, "epoch": epoch, "seconds": seconds, "bytes": size})
        logger.info("%s checkpoint_%s: %d bytes in %.2f s", op, which, size, seconds)

    def _write_checkpoint(self, which: str, model_state=None, optimizer_state=None) -> None:
        """Write checkpoint_<which> from the live state or from a snapshot."""
        t0 = time.perf_counter()
        checkpoint.save(
            self.output_dir / f"checkpoint_{which}", self.model, epoch=self.current_epoch,
            best_val_metric=self.best_val_metric, history=self.history,
            model_state=model_state,
            optimizer_state=optimizer_state or self.optimizer.export_state(self.opt_state, self.model),
        )
        self._log_checkpoint("save", which, self.current_epoch, time.perf_counter() - t0)
        if which == "latest" and self.record_hits and self.hits:
            self._save_hits()  # the sidecar keeps a resume in step

    def save_checkpoint(self, which: str = "latest") -> None:
        """Materialize the lazy optimizer, then write checkpoint_<which>
        ("latest" or "best") from the live state."""
        self._materialize()
        self._write_checkpoint(which)

    def load_checkpoint(self, which: str = "latest") -> dict:
        """Resume from checkpoint_<which>: a fresh optimizer state over the
        model, both filled from the checkpoint; the epoch counter goes on
        after the saved epoch, the best metric and the history come back.
        Returns the optimizer state."""
        self.init_state(reset_parameters=False)
        t0 = time.perf_counter()
        meta = checkpoint.restore(
            self.output_dir / f"checkpoint_{which}", self.model, self.optimizer, self.opt_state
        )
        self._log_checkpoint("restore", which, meta["epoch"], time.perf_counter() - t0)
        self.current_epoch = meta["epoch"] + 1
        self.best_val_metric = meta["best_val_metric"]
        self.history = meta["history"]
        if self.record_hits:
            n = len(self.history["val_metrics"])
            saved = load_hits(self._hits_path) if self._hits_path.exists() else []
            # The sidecar may trail the history if the last save predates evaluations.
            self.hits = (saved + [None] * n)[:n]
        return self.opt_state

    # -- the training loop --------------------------------------------------

    def train(self, resume: bool = False) -> dict:
        """Train from `current_epoch` to `max_epochs` (or an early stop) and
        return the history. With `resume`, first load checkpoint_latest;
        without a state from ``init_state``, start from fresh parameters drawn
        from the Trainer's seed."""
        if resume:
            self.load_checkpoint("latest")
        elif self.opt_state is None:
            self.init_state()
        logger.info("Training %s for up to %d epochs", self.model.name, self.max_epochs)
        trained = False
        for epoch in range(self.current_epoch, self.max_epochs):
            self.current_epoch = epoch
            trained = True
            t0 = time.perf_counter()
            train_loss = self.train_epoch()
            self.history["train_loss"].append(train_loss)
            logger.info("Epoch %d: train_loss=%.4f (%.1f s)", epoch, train_loss, time.perf_counter() - t0)
            if (epoch + 1) % self.eval_every:
                continue
            # evaluate() materializes the lazy optimizer: the best snapshot
            # and the saves after it read the dense-trajectory table too.
            val_metrics = self.evaluate()
            self.history["val_metrics"].append(val_metrics)
            logger.info("Epoch %d: %s", epoch, ", ".join(f"{k}={v:.4f}" for k, v in val_metrics.items()))
            val_metric = val_metrics[f"recall@{self.k_values[0]}"]
            is_best = val_metric > self.best_val_metric
            if is_best:
                self.best_val_metric = val_metric
                self.patience_counter = 0
            else:
                self.patience_counter += 1
            stopping = self.patience_counter >= self.patience
            self._n_evals += 1
            save_latest = (stopping or epoch == self.max_epochs - 1
                           or self._n_evals % self.checkpoint_every == 0)
            if is_best and self.defer_best:
                self._best_snapshot = (
                    _device_copy(self.model.state_dict()),
                    _device_copy(self.optimizer.export_state(self.opt_state, self.model)),
                    epoch,
                )
            if save_latest:
                self._write_checkpoint("latest")
                self._latest_saved_epoch = epoch
            if is_best and not self.defer_best:
                self._write_checkpoint("best")
            if stopping:
                logger.info("Early stopping at epoch %d", epoch)
                break

        # Backstop: checkpoint_latest holds the last trained epoch whatever
        # eval_every, checkpoint_every and max_epochs make of the cadence.
        if trained and self._latest_saved_epoch != self.current_epoch:
            self.save_checkpoint("latest")
            self._latest_saved_epoch = self.current_epoch
        if self._best_snapshot is not None:
            model_state, optimizer_state, best_epoch = self._best_snapshot
            epoch_now, self.current_epoch = self.current_epoch, best_epoch  # meta["epoch"]: the best epoch
            self._write_checkpoint("best", model_state, optimizer_state)
            self.current_epoch = epoch_now
            self._best_snapshot = None

        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / "history.json").write_text(json.dumps(self.history, indent=2))
        if self.record_hits and self.hits:
            self._save_hits()
        return self.history

