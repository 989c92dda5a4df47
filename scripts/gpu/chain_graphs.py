#!/usr/bin/env python3
"""Time two CUDA-graph designs of the chained lazy train step, and the host cost of a step row, on one NVIDIA GPU.

    python3 scripts/gpu/chain_graphs.py

At chip_smoke.py's full width (466,865 items, D = 256, 2 layers, 2 heads,
dropout 0.1, lazy float32 moments), B = 512, N = 56, groups of TIMED_CHAIN
batches of the N = 56 bucket of chip_smoke.py's chained corpus, batches and
indexes already on the card:

- "step": the port's ``make_chained_sparse_train_step``, one graph of a
  single step replayed once per slot, slot i copied into its inputs first;
- "group": one graph of the whole group's steps, captured here from
  ``train/graphs.py::GraphCache`` over a loop of the same step body, its
  inputs copied once per group. The port does not ship it.

Each design trains its own copy of one seeded state; the groups run in turns
step, group, group, step (three rounds after the capture), and afterwards both
states must be equal bit for bit. Per design: wall ms per step (host clock,
each group synchronised at its end), device ms per step (CUDA events around a
group), capture seconds and graph-pool bytes, and from a torch.profiler trace
of one group the host's launch calls per step. Then host microseconds per
call (1,000 calls, 100 for the batch): the one-row step block that an
unchained step copies to the card, and its parts (the rows built with numpy,
pinning 88 bytes, the pinned copy), and one batch of 512 with its index
pinned and copied as the Trainer's unchained loop does.
Prints one JSON line per measurement and the nvidia-smi line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    CHAIN_SESSIONS, DROPOUT, TIMED_CHAIN, TRAIN_BATCH, _same_bits, _state_tensors, group_profile, make_dataset,
    make_training_model, nvidia_smi,
)
from gat_recommendation_torch.data.batching import (  # noqa: E402
    GradIndex, SessionBatch, iterate_batches, make_grad_index, stack_batches, stack_grad_indices, to_device,
)
from gat_recommendation_torch.ops import step_block  # noqa: E402
from gat_recommendation_torch.train import trainer  # noqa: E402
from gat_recommendation_torch.train.graphs import GraphCache  # noqa: E402
from gat_recommendation_torch.train.losses import create_loss_function  # noqa: E402
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW  # noqa: E402


def group_graph_step(model, loss_fn, opt, state):
    """The chained step as one graph of the group's C steps per shape."""
    body = trainer._sparse_step_body(model, loss_fn, opt, state)
    n_batch, n_index = len(dataclasses.fields(SessionBatch)), len(GradIndex._fields)

    def group(*flat):
        batches, gidxs, block = SessionBatch(*flat[:n_batch]), GradIndex(*flat[n_batch:n_batch + n_index]), flat[-1]
        return torch.stack([body(trainer._slot(batches, i), trainer._slot(gidxs, i), block[i])
                            for i in range(block.shape[0])])

    cache = GraphCache(group, trainer._train_state(model, state), state)

    def chained(batches, gidxs, block):
        flat = [*trainer._fields(batches), *trainer._fields(gidxs), block]
        losses = cache.run(tuple(t.shape for t in flat), flat).clone()
        state["count"] += block.shape[0]
        return losses

    chained.graphs = cache
    return chained


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of fn(i) over `calls` calls, synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_graphs: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    epoch = list(iterate_batches(make_dataset(np.random.default_rng(3), CHAIN_SESSIONS), TRAIN_BATCH,
                                 shuffle=True, seed=0))
    n56 = [b for b in epoch if b.nodes_per_session == 56]
    batches = [n56[i % len(n56)] for i in range(TIMED_CHAIN)]
    stacked = to_device((stack_batches(batches), stack_grad_indices([make_grad_index(b) for b in batches])), dev)
    loss_fn = create_loss_function("dual")
    seeds = list(range(TIMED_CHAIN))
    runs = {}
    for design, make in (("step", trainer.make_chained_sparse_train_step), ("group", group_graph_step)):
        model = make_training_model(DROPOUT)
        opt = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True)
        state = opt.init(model)
        step = make(model, loss_fn, opt, state)
        run = (lambda s=step, m=model, o=opt, st=state:
               s(*stacked, trainer.next_steps_block(m, o, st, seeds, dev)))
        run()  # the capture
        torch.cuda.synchronize()
        runs[design] = {"run": run, "model": model, "state": state, "step": step, "walls": [], "device": []}
    for design in ("step", "group", "group", "step") * 3:
        entry = runs[design]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        entry["run"]()
        end.record()
        torch.cuda.synchronize()
        entry["walls"].append((time.perf_counter() - t0) * 1e3 / TIMED_CHAIN)
        entry["device"].append(start.elapsed_time(end) / TIMED_CHAIN)
    for design, entry in runs.items():
        wall = statistics.median(entry["walls"])
        cache = entry["step"].graphs
        entry["profile"] = group_profile(entry["run"], TIMED_CHAIN, wall)
        print(json.dumps({
            "design": design, "shape": f"B={TRAIN_BATCH} N=56 U={stacked[1].uid.shape[1]} C={TIMED_CHAIN}",
            "wall_ms_per_step": wall, "wall_ms_per_step_runs": entry["walls"],
            "device_elapsed_ms_per_step": statistics.median(entry["device"]),
            "graphs": len(cache.graphs), "capture_s": cache.capture_seconds, "pool_bytes": cache.pool_bytes,
            **entry["profile"], "card": smi,
        }), flush=True)
    pairs = list(zip(_state_tensors(runs["step"]["model"], runs["step"]["state"]),
                     _state_tensors(runs["group"]["model"], runs["group"]["state"])))
    if not all(_same_bits(a, b) for a, b in pairs):
        raise AssertionError("the two graph designs left different states")

    model, state = runs["step"]["model"], runs["step"]["state"]
    opt = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True)
    rows = step_block.host_rows(0, [1], b1=opt.b1, b2=opt.b2, num_layers=model.config.num_layers,
                                seeds_per_layer=model.seeds_per_layer)
    host_batch = (batches[0], make_grad_index(batches[0]))
    print(json.dumps({
        "one_row_step_block_us": host_us(lambda i: trainer.next_steps_block(model, opt, state, [i], dev)),
        "host_rows_us": host_us(lambda i: step_block.host_rows(i, [i], b1=opt.b1, b2=opt.b2,
                                                                 num_layers=model.config.num_layers,
                                                                 seeds_per_layer=model.seeds_per_layer)),
        "pin_memory_us": host_us(lambda i: torch.from_numpy(rows).pin_memory()),
        "pinned_copy_us": host_us(lambda i: step_block.to_device(rows, dev)),
        "batch_and_index_to_device_us": host_us(lambda i: to_device(host_batch, dev), calls=100),
        "state_tensors_equal": len(pairs), "card": smi,
    }))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
