"""The cells of BENCHMARK.json at a size a CPU test run holds: a 3,000-item
catalog at width 32, a few hundred sessions, small batches. The entries and
the reference are the cell's own; the limits are the tiny size's, set from
its sound readings on the CPU (loss gaps up to 6e-7, gradient and change
gaps up to 1e-5, score gaps 0) and its emulated TF32 control (loss gaps
1e-5 and more, gradient gaps 3e-4 and more, score gaps 5e-4 and more): the
card's limits hold the card's kernels at the cells' sizes."""

from __future__ import annotations

import copy
import json
import time

from benchmark import harness

TINY_SEED = 2**31 + 12345
LIMITS = {"train": {"loss_gap": 2e-6, "grad_gap": 5e-5, "change_gap": 5e-5, "table_change_gap": 5e-5,
                   "chained_change_gap": 5e-5, "chained_table_change_gap": 5e-5},
          "eval": {"score_gap": 1e-4, "malformed": 0.0}}


def shrink(config: dict, traffic: dict) -> tuple[dict, dict]:
    config = dict(config, num_items=3000, embedding_dim=32, hidden_dim=32, laplacian_k=4)
    traffic = copy.deepcopy(traffic)
    traffic["batch_size"] = 16 if traffic["entry"] == "train" else 32
    if "warm_up_epochs" in traffic:  # one epoch of each epoch order
        traffic["warm_up_epochs"] = harness.load_module(harness.HERE / "entries" / "train.py").EPOCH_ORDERS
    if traffic["entry"] == "train":  # a chained group of 8: the check's chained epoch is one whole group
        traffic["chain"] = 8
    traffic["corpus"]["train"]["sessions"] = 600
    traffic["corpus"]["val"]["sessions"] = 200
    return config, traffic


def cell(name: str, root=harness.ROOT) -> harness.Cell:
    c = harness.Cell(json.loads((root / "BENCHMARK.json").read_text()), name, here=root / "benchmark")
    c.config, c.traffic = shrink(c.config, c.traffic)
    c.limits = LIMITS[c.traffic["entry"]]
    return c


def run(c: harness.Cell, trace: bool = False, seed: int = TINY_SEED, seconds: float = 0.5) -> dict:
    return harness.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter())
