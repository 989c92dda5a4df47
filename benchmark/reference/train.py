"""The training check: the first steps of a training run, taken again.

The run's set-up drives the program's Trainer through check epochs of
chosen batches (``check_plan``): three epochs of one step each, then one
epoch of the traffic's ``chain`` steps of one bucket, which the Trainer runs
as one full chained group, the CUDA graph that carries the window's steps.
The reference takes the same steps from the same weights: the loss of every
epoch, the gradient of the first step and the change of every parameter
over the first three steps and again over all of them, under dense AdamW
(which the lazy and the eager table updates of the program equal, the lazy
one once its pending rows are caught up).

``compare`` turns the two sides' readings into the numbers that decide
``correct``:

- ``loss_gap``: the largest relative gap of an epoch's mean loss;
- ``grad_gap``: the largest gap between the two sides' norms of a
  parameter's first gradient, over the larger of that parameter's reference
  norm and the median parameter's;
- ``change_gap``: the median parameter's gap of the change over the first
  three steps, each parameter's gap over the larger of its reference norm
  and the median parameter's, leaving out the parameters whose first
  reference gradient is below a thousandth of the median parameter's (a
  key's bias under the softmax: its gradient is rounding, and AdamW moves
  it by round-off alone);
- ``table_change_gap``: the item table's gap of the change (the rows that
  the lazy or the eager table update moved);
- ``chained_change_gap`` and ``chained_table_change_gap``: the same two
  after the chained epoch as well (its per-slot step seeds, its blocks of
  rows and, in the lazy optimizer, the catch-up across its slots).

The worst parameter's change gap is reported beside them, not compared: a
bias that a BatchNorm follows (``convs.0.skip.bias``) has a gradient close
to rounding in some of its entries, AdamW's normalized steps turn their
rounding into whole steps, and that one small parameter's gap swings from
seed to seed by a factor of twenty.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import batches as rb
from benchmark.reference import hashing
from benchmark.reference import model as rm

SINGLES = 3
EXCLUDE_BELOW = 1e-3
FAULTS = ("half_batch", "altered_target")
WITNESSES = ("float64",)  # a second sound computation, for a look at the seeds that read high


def check_plan(buckets: list[int], chain: int) -> list[list[int]]:
    """Batch indices of one epoch order for the check epochs: three single
    steps (the last batch of the largest bucket, then the first batch of
    each next smaller one, the smallest last), then `chain` batches (the
    traffic's whole chained group) of the smallest bucket that holds enough
    of them."""
    sizes = sorted(set(buckets), reverse=True)
    first = {n: buckets.index(n) for n in sizes}
    last = {n: len(buckets) - 1 - buckets[::-1].index(n) for n in sizes}
    singles = [last[sizes[0]]] + [first[n] for n in sizes[1:]]
    for n in sizes:  # fewer buckets than singles: take more batches of the largest ones
        singles += [i for i in range(first[n], last[n] + 1) if i not in singles]
    singles = singles[:SINGLES]
    for n in reversed(sizes):
        run = [i for i in range(first[n], last[n] + 1) if i not in singles][:chain]
        if len(run) == chain:
            return [[i] for i in singles] + [run]
    raise ValueError(f"no bucket holds {chain} batches besides the single steps")


def device_batch(b: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


class Trajectory:
    """Dense AdamW over the reference model, from given weights."""

    def __init__(self, cfg: dict, weights: dict, prec: rm.Precision):
        self.cfg, self.prec = cfg, prec
        self.P = {k: v.clone().requires_grad_(rm.is_parameter(k)) for k, v in weights.items()}
        self.leaves = [k for k in self.P if rm.is_parameter(k)]
        self.m = {k: torch.zeros_like(self.P[k]) for k in self.leaves}
        self.v = {k: torch.zeros_like(self.P[k]) for k in self.leaves}
        self.count = 0

    def step(self, batch: dict, step_seed: int) -> tuple[float, dict]:
        cfg = self.cfg
        with self.prec:
            sess = rm.forward(self.P, cfg, batch, self.prec, train=True, step_seed=step_seed)
            loss = rm.dual_loss(cfg, self.P, sess, batch, self.prec)
            grads = dict(zip(self.leaves, torch.autograd.grad(loss, [self.P[k] for k in self.leaves])))
        grads["item_embedding"][0] = 0.0  # the padding item never updates
        self.count += 1
        b1, b2 = np.float32(cfg["b1"]), np.float32(cfg["b2"])
        bc1 = float(np.float32(1.0) - b1 ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - b2 ** np.float32(self.count))
        lr, wd, eps = cfg["lr"], cfg["weight_decay"], cfg["eps"]
        with torch.no_grad():
            for k in self.leaves:
                g, p = grads[k], self.P[k]
                self.m[k].mul_(cfg["b1"]).add_(g, alpha=1.0 - cfg["b1"])
                self.v[k].mul_(cfg["b2"]).addcmul_(g, g, value=1.0 - cfg["b2"])
                p.mul_(1.0 - lr * wd)
                p.sub_(lr * (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + eps))
        return float(loss.detach()), grads


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tensors.items()}


def readings(cfg: dict, traffic: dict, data: dict, seed: int, device, variant: str = "exact") -> dict:
    """The reference's readings of the check epochs: {"loss": [per epoch],
    "grad": {leaf: norm of the first gradient}, "change": {leaf: norm of the
    change over the first three steps}, "chained_change": {leaf: the same
    after the chained epoch}}. `variant`: "exact" (float32), "tf32"
    (the control: every product on TF32 operands), a fault of ``FAULTS``
    planted in the reference (half of each batch's valid samples left out
    of the loss, or one target altered where the batch is made), or
    "float64", the witness: the same reference from the same weights in
    float64, which shows how far two sound computations part on a seed."""
    sessions = rb.Sessions.from_columns(*data["train"], cfg["max_session_length"])
    graph = rb.csr(*data["edges"], cfg["num_items"])
    B = traffic["batch_size"]
    sched = rb.schedule(sessions, B, seed, shuffle=True)
    plan = check_plan([n for _, n, _ in sched], traffic["chain"])
    weights = rm.draw_weights(cfg, seed, device)
    if variant == "float64":
        weights = {k: v.double() for k, v in weights.items()}
    traj = Trajectory(cfg, weights, rm.Precision(tf32=variant == "tf32", device=device))
    out = {"loss": [], "grad": {}, "change": {}, "chained_change": {}}
    for epoch, idxs in enumerate(plan):
        losses = []
        for step, i in enumerate(idxs):
            chunk, n, bi = sched[i]
            b = rb.assemble(sessions, graph, chunk, B, n, seed, bi, cfg["num_items"], cfg["num_negatives"])
            if variant == "half_batch":
                valid = np.flatnonzero(b["sample_mask"])
                b["sample_mask"][valid[len(valid) // 2:]] = False
            elif variant == "altered_target" and step == 0:
                b["targets"][0] = 1 + b["targets"][0] % (cfg["num_items"] - 1)
            loss, grads = traj.step(device_batch(b, device), hashing.mix_seed(seed, epoch, step))
            losses.append(loss)
            if traj.count == 1:
                out["grad"] = norms(grads)
        out["loss"].append(float(np.mean(losses)))
        if epoch in (SINGLES - 1, len(plan) - 1):
            key = "change" if epoch == SINGLES - 1 else "chained_change"
            out[key] = norms({k: traj.P[k].detach() - weights[k] for k in traj.leaves})
    return out


def compare(program: dict, reference: dict) -> tuple[dict, dict]:
    """({number: value}, details) of the program's readings against the reference's."""
    lp, lr = np.array(program["loss"]), np.array(reference["loss"])
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr))) if len(lp) == len(lr) else float("inf")
    g_ref = reference["grad"]
    median_g = float(np.median(list(g_ref.values())))
    kept = [k for k in g_ref if g_ref[k] >= EXCLUDE_BELOW * median_g]

    def gaps(prog: dict, ref: dict, leaves: list) -> dict:
        med = float(np.median([ref[k] for k in leaves]))
        out = {k: abs(prog.get(k, float("nan")) - ref[k]) / max(ref[k], med) for k in leaves}
        return {k: (float("inf") if not np.isfinite(v) else v) for k, v in out.items()}

    grad = gaps(program["grad"], g_ref, list(g_ref))
    change = gaps(program["change"], reference["change"], kept)
    chained = gaps(program["chained_change"], reference["chained_change"], kept)
    grad_leaf, change_leaf = max(grad, key=grad.get), max(change, key=change.get)
    if not np.all(np.isfinite(lp)):
        loss_gap = float("inf")
    numbers = {"loss_gap": loss_gap, "grad_gap": grad[grad_leaf], "change_gap": float(np.median(list(change.values()))),
               "table_change_gap": change["item_embedding"],
               "chained_change_gap": float(np.median(list(chained.values()))),
               "chained_table_change_gap": chained["item_embedding"]}
    chained_leaf = max(chained, key=chained.get)
    details = {"grad_leaf": grad_leaf, "worst_change_leaf": change_leaf, "worst_change_gap": change[change_leaf],
               "worst_chained_change_leaf": chained_leaf, "worst_chained_change_gap": chained[chained_leaf],
               "left_out": sorted(set(g_ref) - set(kept)), "loss_program": lp.tolist(), "loss_reference": lr.tolist()}
    return numbers, details
