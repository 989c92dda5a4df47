"""Training cells: the window runs ``Trainer.train_epoch()`` over whole epochs.

Set-up builds one Trainer (``benchmark/program.py``) and drives it from the
seed's weights through the check epochs (``reference/train.py::check_plan``:
three epochs of one step, then one of the traffic's ``chain`` steps of one
bucket, which the Trainer runs as one full chained group, the CUDA graph
that carries the window's steps), through the same call and feed as the
window: ``train_epoch`` over ``iterate_batches`` with the assembly threads,
behind the Trainer's prefetch. It reads each epoch's mean loss, the first
gradient from the optimizer's first moments after step one
(m = (1 - b1) g), and, after step three and again after the chained epoch,
each parameter's change, once the lazy optimizer has flushed. Then it warms
up for ``warm_up_epochs`` epochs, which go through each of the
``EPOCH_ORDERS`` epoch orders that the window then cycles through (epoch e
takes order ``seed + e % EPOCH_ORDERS``), so that every graph the window
replays is captured before it. The same Trainer goes on into the window.

``train_sessions_per_s``: the sessions of the window's epochs over the time
from the window's start to the return of its last epoch, whose readback ends
it.
"""

from __future__ import annotations

import math
import time

from benchmark import corpus, program
from benchmark.observe import Observer
from benchmark.reference import train as rt

EPOCH_ORDERS = 2  # the window's epochs cycle through this many shuffles of the sessions


def picked(iterator, wanted: list[int]):
    """The batches at positions `wanted` of an epoch's iterator, in order."""
    wanted_set, last = set(wanted), max(wanted)
    try:
        for i, batch in enumerate(iterator):
            if i in wanted_set:
                yield batch
            if i == last:
                return
    finally:
        iterator.close()


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, clock, observe: bool = False,
                 warm_up: bool = True):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.data, self.ds, model, weights = program.prepare(cfg, traffic, seed, device, clock, "train")
        self.observer = Observer(cfg["num_items"], track_rows=True) if observe else None
        with clock.part("init_state"):
            self.trainer = program.trainer(cfg, traffic, model, seed, device, self.feed, lambda: iter(()))
        self.chained_steps = 0
        self._count_chained()
        self.buckets = program.batches_per_epoch(self.ds.unique_counts, traffic["batch_size"])
        with clock.part("check_steps"):
            self.readings = self._check_steps(weights)
        del weights
        self.epoch = len(self.readings["loss"])
        with clock.part("warm_up"):
            for _ in range(traffic["warm_up_epochs"] if warm_up else 0):
                self._epoch()

    def _count_chained(self) -> None:
        """Count the steps the Trainer's chained dispatches carry (a full
        group, or a partial group's sub-chain), around its chained step."""
        step = getattr(self.trainer, "_chained_step", None)
        if step is None:
            return

        def counted(batches, gidxs, block):
            self.chained_steps += int(block.shape[0])
            return step(batches, gidxs, block)

        counted.graphs = getattr(step, "graphs", None)
        self.trainer._chained_step = counted

    def _order(self, order: int):
        from gat_recommendation_torch.data.batching import iterate_batches

        return iterate_batches(self.ds, batch_size=self.traffic["batch_size"], shuffle=True,
                                    seed=self.seed + order, workers=self.traffic["workers"])

    def _watched(self, iterator):
        return self.observer.wrap(iterator) if self.observer is not None else iterator

    def feed(self, epoch: int):
        """The Trainer's ``train_batches``: epoch e takes epoch order e mod EPOCH_ORDERS."""
        return self._watched(self._order(epoch % EPOCH_ORDERS))

    def _epoch(self) -> float:
        self.trainer.current_epoch = self.epoch
        self.epoch += 1
        return self.trainer.train_epoch()

    def _check_steps(self, weights: dict) -> dict:
        tr, b1 = self.trainer, self.cfg["b1"]
        plan = rt.check_plan(self.buckets, self.traffic["chain"])
        out = {"loss": [], "grad": {}, "change": {}, "chained_change": {}}
        params = dict(tr.model.named_parameters())
        for epoch, idxs in enumerate(plan):
            tr.current_epoch = epoch
            tr.train_batches = lambda _epoch, idxs=idxs: self._watched(picked(self._order(0), idxs))
            out["loss"].append(tr.train_epoch())
            if epoch == 0:
                state = tr.optimizer.export_state(tr.opt_state, tr.model)
                out["grad"] = {k: program.norm(state["emb_mu" if k == "item_embedding" else f"rest.{k}.exp_avg"])
                               / (1.0 - b1) for k in params}
            if epoch in (rt.SINGLES - 1, len(plan) - 1):
                tr.optimizer.materialize(tr.model, tr.opt_state)
                key = "change" if epoch == rt.SINGLES - 1 else "chained_change"
                out[key] = {k: program.norm(p.detach() - weights[k]) for k, p in params.items()}
        tr.train_batches = self.feed
        return out

    def graphs(self):
        return program.graphs_captured(getattr(self.trainer, "_chained_step", None))

    def window(self, seconds: float, tracer=None, observe: bool = False) -> dict:
        """Whole epochs until `seconds` have passed. `observe`: the
        observer records this window, and closes after it."""
        tr = self.trainer
        graphs, chained, chained_steps = self.graphs(), tr.chained_dispatches, self.chained_steps
        if observe:
            self.observer.recording = True
        if tracer is not None:
            tracer.begin()
        losses, ends = [], []
        start = time.perf_counter()
        while not losses or time.perf_counter() - start < seconds:
            losses.append(self._epoch())
            ends.append(time.perf_counter() - start)
        if tracer is not None:
            tracer.end()
        elapsed = time.perf_counter() - start
        if observe:
            self.observer.close()
        steps = len(self.buckets)
        sessions = len(losses) * len(self.ds)
        after = self.graphs()
        return {"seconds": elapsed, "epochs": len(losses), "sessions": sessions,
                "attempted": len(losses) * steps,
                "failed": sum(steps for loss in losses if not math.isfinite(loss)),
                "chained_dispatches": tr.chained_dispatches - chained,
                "chained_steps": self.chained_steps - chained_steps,
                "graphs_captured_in_window": None if after is None else after - graphs,
                "epoch_loss_first_last": [losses[0], losses[-1]],
                "epoch_seconds": [round(b - a, 4) for a, b in zip([0.0] + ends, ends)],
                "metrics": {"train_sessions_per_s": sessions / elapsed}}

    def observation(self, window: dict, trace) -> dict:
        obs = self.observer
        return {"config": self.cfg, "traffic": self.traffic, "trace": trace, "window": window,
                "batches": obs.batches, "waits": obs.waits, "steps": len(obs.batches),
                "chained_steps": window["chained_steps"]}

    def close(self) -> dict:
        out = {"program": self.readings, "data": self.data}
        self.trainer = self.ds = None
        return out


def check(cfg: dict, traffic: dict, seed: int, device, outputs: dict) -> tuple[dict, dict]:
    reference = rt.readings(cfg, traffic, outputs["data"], seed, device)
    return rt.compare(outputs["program"], reference)


def stand_in(cfg: dict, traffic: dict, seed: int, device, variant: str) -> tuple[dict, dict]:
    """The reference in `variant` (the TF32 control, a planted fault, or the
    float64 witness) put in the program's place, judged as the program is."""
    data = corpus.make(traffic["corpus"], cfg["num_items"], seed)
    return rt.compare(rt.readings(cfg, traffic, data, seed, device, variant),
                      rt.readings(cfg, traffic, data, seed, device))


VARIANTS = ("tf32",) + rt.FAULTS + rt.WITNESSES
