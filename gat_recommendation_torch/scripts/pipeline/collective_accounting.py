"""Per-step collective traffic of the port's sharded steps.

    python3 -m gat_recommendation_torch.scripts.pipeline.collective_accounting --mesh 4x2 [--lazy]

The port of ``scripts/pipeline/collective_accounting.py``: the same flags
(``--out`` defaults to ``outputs/collective_accounting_torch.json``, beside
the JAX script's files), the same cases and the same JSON schema (``mesh``,
``config``, ``steps.<case>.{n_collectives, total_bytes, by_op_axis}``, and
``per_step_bytes`` for the chained case). The JAX script compiles the
sharded steps over virtual CPU devices and inventories the collectives of
the optimized HLO; the port has no HLO, so it counts what its steps issue.
The script starts one process a rank (``torch.distributed`` over gloo on the
CPU, one DATAxMODEL mesh), runs each case once on every rank with
``torch.distributed``'s collectives wrapped, and records each call: op
(``all-reduce``, ``all-gather``, ``reduce-scatter``, ``broadcast``, as HLO
names them), dtype, shapes, the bytes of its result (as the JAX script
counts a collective's result shape) and its mesh axis, from the group: the
mesh's 'data' or 'model' group, ``all`` where the group spans every rank.
Every rank must issue the same calls; rank 0's are reported.

Cases, at the reference scale by default (466,865 x 256, a global batch of
512 from the bench's ``make_batches``, seed 0, node bucket 8; chain 8):

- ``sparse_train_step``: ``parallel/steps.py::make_sharded_sparse_train_step``
  (eager with B1's plain twin, or ``--lazy``);
- ``chained_sparse_step_C{chain}``: ``make_chained_sharded_sparse_train_step``
  over ``chain`` copies of the batch; ``per_step_bytes`` = total / chain;
- ``eval_step_gspmd``: ``make_sharded_eval_step`` (a dense top-k a shard, the
  port's twin of the JAX package's GSPMD eval step), k = 20;
- ``eval_step_v2_twophase``: ``parallel/topk.py::make_sharded_eval_step_v2``.

At the reference scale a rank holds its 1 / MODEL of the table, its moments
and (lazy) ``last_step``, about 1.5 GB on a 1x1 mesh, and builds the whole
table once before it is cut: run it where the ranks' memory fits.
``account(...)`` is the same at any width (the tests call it small).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NUM_ITEMS = 466_865
BATCH = 512
DIM = 256
CHAIN = 8
TOP_K = 20
TIMEOUT_S = 3600  # for a group of ranks to report at the reference scale

# The wrapped collectives: torch.distributed's name, the HLO op it stands for,
# and the position of its `group` argument.
OPS = {
    "all_reduce": ("all-reduce", 2),
    "all_gather": ("all-gather", 2),
    "all_gather_into_tensor": ("all-gather", 2),
    "reduce_scatter": ("reduce-scatter", 3),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "broadcast": ("broadcast", 2),
}


def _result(name: str, args: tuple, kwargs: dict) -> list[torch.Tensor]:
    """The tensors a collective's call leaves its result in: the tensor
    itself (all_reduce, broadcast), the output list (all_gather) or the
    output tensor (the other forms)."""
    if name in ("all_reduce", "broadcast"):
        return [args[0] if args else kwargs["tensor"]]
    out = args[0] if args else kwargs.get("tensor_list", kwargs.get("output"))
    return list(out) if name == "all_gather" else [out]


def _axis(group, mesh) -> str:
    """The mesh axis a group spans: ``all`` when it holds every rank, else
    'data' or 'model' by its ranks."""
    ranks = dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)
    if len(ranks) == dist.get_world_size():
        return "all"
    for axis in ("data", "model"):
        if ranks == dist.get_process_group_ranks(mesh.get_group(axis)):
            return axis
    return "?"


@contextlib.contextmanager
def recording(mesh, calls: list):
    """Inside, every wrapped collective of ``torch.distributed`` appends
    {op, axis, dtype, shape, bytes} to `calls`, then runs."""
    originals = {name: getattr(dist, name) for name in OPS}

    def wrap(name, fn):
        op, group_at = OPS[name]

        def collective(*args, **kwargs):
            group = args[group_at] if len(args) > group_at else kwargs.get("group")
            out = _result(name, args, kwargs)
            calls.append({"op": op, "axis": _axis(group, mesh), "dtype": str(out[0].dtype).split(".")[-1],
                          "shape": [list(t.shape) for t in out],
                          "bytes": sum(t.numel() * t.element_size() for t in out)})
            return fn(*args, **kwargs)
        return collective

    for name, fn in originals.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def summarize(calls: list) -> dict:
    """The JAX script's summary of a case: total bytes, count and bytes by op/axis, count."""
    by = {}
    for c in calls:
        entry = by.setdefault(f'{c["op"]}/{c["axis"]}', {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += c["bytes"]
    return {"total_bytes": sum(c["bytes"] for c in calls), "by_op_axis": by, "n_collectives": len(calls)}


def _cases(n_data: int, n_model: int, num_items: int, chain: int, lazy: bool, dim: int, batch: int) -> dict:
    """On this rank of the initialised group: each case's recorded calls,
    and the bucket of the accounted batch."""
    from gat_recommendation_torch.bench import make_batches
    from gat_recommendation_torch.data.batching import make_grad_index, stack_batches, stack_grad_indices, to_device
    from gat_recommendation_torch.models.registry import create_model
    from gat_recommendation_torch.parallel import mesh as parallel_mesh, steps, topk
    from gat_recommendation_torch.train.losses import create_loss_function
    from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
    from gat_recommendation_torch.train.trainer import next_steps_block

    mesh = parallel_mesh.make_mesh(n_data, n_model, device="cpu")
    model = create_model("graph_transformer_optimized", num_items, embedding_dim=dim, hidden_dim=dim, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    parallel_mesh.shard_model(model, mesh)
    optimizer = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=lazy)
    state = optimizer.init(model)
    loss_fn = create_loss_function("dual")
    hb = make_batches(num_items, batch, 1, seed=0)[0]
    gidx = make_grad_index(hb)
    local = steps.shard_batch(hb, mesh)
    stacked = steps.shard_chained_batch(stack_batches([hb] * chain), mesh)
    gidxs = to_device(stack_grad_indices([gidx] * chain), "cpu")
    step = steps.make_sharded_sparse_train_step(model, loss_fn, optimizer, state, mesh)
    chained = steps.make_chained_sharded_sparse_train_step(model, loss_fn, optimizer, state, mesh)
    runs = {
        "sparse_train_step": lambda: step((local, to_device(gidx, "cpu")), 0),
        f"chained_sparse_step_C{chain}": lambda: chained(
            stacked, gidxs, next_steps_block(model, optimizer, state, list(range(chain)), "cpu")),
        "eval_step_gspmd": lambda: steps.make_sharded_eval_step(model, TOP_K, mesh)(local),
        "eval_step_v2_twophase": lambda: topk.make_sharded_eval_step_v2(model, TOP_K, mesh)(local),
    }
    out = {}
    for name, run in runs.items():
        with recording(mesh, []) as calls:
            run()
        out[name] = calls
    return {"calls": out, "bucket_n": int(hb.node_ids.shape[1])}


def _worker(rank: int, world: int, port: int, spec: dict, queue) -> None:
    from gat_recommendation_torch.parallel import distributed

    torch.set_num_threads(spec.pop("threads"))
    try:
        distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
        queue.put((rank, "ok", _cases(**spec)))
    except BaseException:  # noqa: BLE001 - the parent reports it
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        distributed.shutdown()


def account(n_data: int, n_model: int, num_items: int = NUM_ITEMS, chain: int = CHAIN, lazy: bool = False,
            dim: int = DIM, batch: int = BATCH, threads: int | None = None, timeout: float = TIMEOUT_S) -> dict:
    """The JSON of the JAX script for a DATAxMODEL mesh: one spawned process a
    rank over gloo, each case run once on every rank with its collectives
    recorded. Raises if a rank fails, if the ranks issue different calls, or
    after `timeout` seconds (every process is ended on every exit path)."""
    from gat_recommendation_torch.parallel import distributed

    world = n_data * n_model
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    spec = dict(n_data=n_data, n_model=n_model, num_items=num_items, chain=chain, lazy=lazy, dim=dim, batch=batch,
                threads=threads)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = distributed.free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, dict(spec), queue)) for r in range(world)]
    for p in procs:
        p.start()
    results, error = {}, None
    try:
        for _ in range(world):
            rank, status, out = queue.get(timeout=timeout)
            if status != "ok":  # the other ranks may wait for it in a collective: stop them
                error = f"rank {rank}:\n{out}"
                break
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=0 if error else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if error:
        raise RuntimeError(f"collective accounting on {n_data}x{n_model}: {error}")
    calls = results[0]["calls"]
    for rank, out in results.items():
        strip = {name: [(c["op"], c["axis"], c["bytes"]) for c in cs] for name, cs in out["calls"].items()}
        if strip != {name: [(c["op"], c["axis"], c["bytes"]) for c in cs] for name, cs in calls.items()}:
            raise RuntimeError(f"rank {rank} issued other collectives than rank 0")
    steps_out = {}
    for name, cs in calls.items():
        summary = summarize(cs)
        if name.startswith("chained"):  # per optimizer step
            summary["per_step_bytes"] = summary["total_bytes"] / chain
        steps_out[name] = summary
    return {"mesh": {"data": n_data, "model": n_model},
            "config": {"num_items": num_items, "batch": batch, "dim": dim, "bucket_n": results[0]["bucket_n"]},
            "steps": steps_out, "calls": calls}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mesh", default="4x2", help="DATAxMODEL, e.g. 4x2")
    p.add_argument("--num-items", type=int, default=NUM_ITEMS)
    p.add_argument("--chain", type=int, default=CHAIN)
    p.add_argument("--lazy", action="store_true",
                   help="account the lazy catch-up AdamW step instead of the eager one (B1)")
    p.add_argument("--out", default="outputs/collective_accounting_torch.json")
    args = p.parse_args(argv)
    n_data, n_model = (int(x) for x in args.mesh.split("x"))
    results = account(n_data, n_model, args.num_items, args.chain, args.lazy)
    calls = results.pop("calls")
    for name, summary in results["steps"].items():
        print(f"== {name}: {summary['n_collectives']} collectives, {summary['total_bytes'] / 1e6:.3f} MB")
        for key, e in sorted(summary["by_op_axis"].items()):
            print(f"   {key:28s} x{e['count']:<3d} {e['bytes'] / 1e6:.3f} MB")
        if not name.startswith("chained"):  # a chained case repeats its step's calls
            for c in calls[name]:
                print(f"     {c['op']:14s} {c['axis']:5s} {c['dtype']:8s} {c['shape']} {c['bytes']} B")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
