"""The evaluation cell: the window runs ``Trainer.evaluate()`` again and again.

Set-up builds the Trainer as for training (``benchmark/program.py``), with
the validation batches from ``iterate_batches`` in their fixed order, and
the seed's weights; ``evaluate`` flushes the lazy optimizer, scores every
validation session over the full catalog (chained groups as CUDA graphs,
partial groups one batch at a time), reads the top-k back once and computes
recall and NDCG. The warm-up is one pass, which captures the graphs. Each
pass's top-k lists are kept as the program returns them (the Trainer's two
eval steps are wrapped, nothing else changes), and the check judges every
list of every pass of every window against the reference
(``reference/evaluate.py``).

``eval_sessions_per_s``: the sessions scored in the window's passes over the
time from the window's start to the return of its last pass.
"""

from __future__ import annotations

import math
import time

from benchmark import corpus, program
from benchmark.observe import Observer
from benchmark.reference import evaluate as re


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, clock, observe: bool = False,
                 warm_up: bool = True):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.data, self.ds, model, _ = program.prepare(cfg, traffic, seed, device, clock, "val")
        self.observer = Observer(cfg["num_items"], track_rows=False) if observe else None
        with clock.part("init_state"):
            self.trainer = program.trainer(cfg, traffic, model, seed, device, lambda epoch: iter(()), self.feed)
        self.lists: list = []  # the current pass's top-k lists, one [slots, k] tensor a batch
        self.passes: list = []  # every window's passes, for the check
        self._record()
        if warm_up:
            with clock.part("warm_up"):
                self.trainer.evaluate()
        self.lists = []

    def feed(self):
        from gat_recommendation_torch.data.batching import iterate_batches

        it = iterate_batches(self.ds, batch_size=self.traffic["batch_size"], shuffle=False, seed=0,
                                  workers=self.traffic["workers"])
        return self.observer.wrap(it) if self.observer is not None else it

    def _record(self) -> None:
        """Keep every top-k list the Trainer's eval steps return (the chained
        step returns [C, slots, k]: C batches)."""
        tr = self.trainer
        single, chained = tr._eval_step, tr._chained_eval

        def single_kept(batch):
            out = single(batch)
            self.lists.append(out)
            return out

        def chained_kept(batches):
            out = chained(batches)
            self.lists.extend(out.unbind(0))
            return out

        tr._eval_step = single_kept
        if chained is not None:
            tr._chained_eval = chained_kept
            chained_kept.graphs = getattr(chained, "graphs", None)

    def graphs(self):
        return program.graphs_captured(getattr(self.trainer, "_chained_eval", None))

    def window(self, seconds: float, tracer=None, observe: bool = False) -> dict:
        """Whole passes until `seconds` have passed. `observe`: the
        observer records this window, and closes after it."""
        tr = self.trainer
        graphs, chained = self.graphs(), tr.chained_eval_dispatches
        if observe:
            self.observer.recording = True
        if tracer is not None:
            tracer.begin()
        passes, metrics, ends = [], [], []
        start = time.perf_counter()
        while not passes or time.perf_counter() - start < seconds:
            metrics.append(tr.evaluate())
            ends.append(time.perf_counter() - start)
            passes.append(self.lists)
            self.lists = []
        if tracer is not None:
            tracer.end()
        elapsed = time.perf_counter() - start
        if observe:
            self.observer.close()
        self.passes.extend(passes)
        after = self.graphs()
        sessions = len(passes) * len(self.ds)
        bad = sum(1 for m in metrics if not all(math.isfinite(v) for v in m.values()))
        return {"seconds": elapsed, "passes": len(passes), "sessions": sessions, "attempted": sessions,
                "failed": bad * len(self.ds), "chained_eval_dispatches": tr.chained_eval_dispatches - chained,
                "graphs_captured_in_window": None if after is None else after - graphs,
                "first_pass_metrics": metrics[0],
                "pass_seconds": [round(b - a, 4) for a, b in zip([0.0] + ends, ends)], "metrics": {"eval_sessions_per_s": sessions / elapsed}}

    def observation(self, window: dict, trace) -> dict:
        obs = self.observer
        return {"config": self.cfg, "traffic": self.traffic, "trace": trace, "window": window,
                "batches": obs.batches, "waits": obs.waits, "eval_batches": len(obs.batches),
                "chained_eval_dispatches": window["chained_eval_dispatches"]}

    def close(self) -> dict:
        passes = [[t.cpu() for t in p] for p in self.passes]
        out = {"passes": passes, "data": self.data}
        self.trainer = self.ds = self.passes = None
        return out


def numbers(judged: dict) -> tuple[dict, dict]:
    """An answer judged reads its gap; no answer at all reads infinity."""
    gap = judged["score_gap"] if judged["answers"] else float("inf")
    return {"score_gap": gap, "malformed": float(judged["malformed"])}, judged


def check(cfg: dict, traffic: dict, seed: int, device, outputs: dict) -> tuple[dict, dict]:
    return numbers(re.judge(cfg, traffic, outputs["data"], seed, device, outputs["passes"]))


def stand_in(cfg: dict, traffic: dict, seed: int, device, variant: str) -> tuple[dict, dict]:
    data = corpus.make(traffic["corpus"], cfg["num_items"], seed)
    return numbers(re.judge(cfg, traffic, data, seed, device, None, variant))


VARIANTS = ("tf32",) + re.FAULTS
