"""Training over a ('data', 'model') mesh: the port on gloo against the JAX package's sharded steps.

Each mesh shape (2x1, 1x2, 2x2) is one group of spawned CPU processes
(``torch.distributed`` on gloo, one thread each), which runs every check of
that shape and sends its results back; JAX runs only in the pytest process,
on the conftest's 8 virtual CPU devices, on a mesh of the same shape. The
port's sharded eager sparse step (B1's plain twin), lazy steps (touch sets
that change, then ``materialize``) and dense step are held against the JAX
sharded steps from the same weights and batches (dropout 0: the packages'
random streams differ), and against the port's one-process steps: loss 1e-5
relative, weights 1e-6 (``_assert_weights_close``: the few entries that
AdamW's division turns from rounding noise into a share of lr stay within
2e-5), moments 1e-6, ``last_step`` equal. The attention's key bias, whose
gradient is rounding noise (the softmax is invariant to it), is left out,
as in ``tests/test_torch_train_step.py``. With dropout 0.1 the sharded
step equals the one-process step (each data rank draws the whole batch's
bits at its rows). The two-phase top-k's ids equal
``parallel/topk.py::sharded_topk``'s, ties and a shard of padding alone
included. BatchNorm and the loss take the global batch's statistics when one
data rank's slots are mostly padding. A 2-process Trainer (2x1 and 1x2)
equals the 1-process one over two epochs with evaluation, its checkpoint
loads on one process, and a one-process checkpoint loads on the mesh.

Chained steps under the mesh (ROADMAP A8b): the chained sharded step over a
group of 4, a sub-chain of 2 and a single step EQUALS seven unchained sharded
steps bit for bit (losses, table, moments, ``last_step``, every other
tensor), eager and lazy, at dropout 0.1, in every shape's workers; and the
2-process Trainer at ``chain=4`` (a full group and a partial one of singles
an epoch) matches the JAX mesh Trainer at ``chain=4`` from the same weights at
dropout 0 (loss 1e-5 relative, metrics 1e-9, weights as
``_assert_weights_close``).

Every spawn has its own timeout and every worker leaves the process group on
every exit path.
"""

from __future__ import annotations

import dataclasses
import re
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gat_recommendation_torch.data import batching as port_batching
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.ops import shard
from gat_recommendation_torch.ops.masked import masked_batch_norm
from gat_recommendation_torch.parallel import distributed, mesh as port_mesh, steps, topk
from gat_recommendation_torch.train import trainer as port_trainer
from gat_recommendation_torch.train.losses import _masked_mean, create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW

torch.set_num_threads(1)

V, DIM, K, BATCH = 104, 16, 5, 8
HP = dict(learning_rate=1e-3, weight_decay=1e-5)
SHAPES = [(2, 1), (1, 2), (2, 2)]
SPAWN_TIMEOUT = 240  # seconds for a group of workers to report
LOSS_RTOL = 1e-5
MOMENT_ATOL = 1e-6
NOISE_GRADIENT = re.compile(r"\.key\.bias$")
TOPK_CASES = [(64, 5), (100, 10), (97, 7), (20, 5)]  # (V, k); V = 20 leaves a shard of padding alone


# ---------------------------------------------------------------------------
# inputs, made from seeds with numpy (the same in every process)
# ---------------------------------------------------------------------------


def _samples(seed: int) -> list:
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(BATCH):
        n = int(rng.integers(2, 6))
        nodes = np.sort(rng.choice(np.arange(1, V), size=n, replace=False)).astype(np.int32)
        m = int(rng.integers(1, n * n))
        samples.append({"nodes": nodes, "edge_src": rng.integers(0, n, m).astype(np.int32),
                        "edge_dst": rng.integers(0, n, m).astype(np.int32),
                        "target": int(rng.integers(1, V)), "negatives": rng.integers(1, V, K).astype(np.int32)})
    return samples


BATCH_SEEDS = [0, 11, 23]  # three batches over other items: the lazy touch sets change


def _port_batches() -> list:
    return [port_batching.collate(_samples(s), 8, K) for s in BATCH_SEEDS]


def _topk_inputs(V_: int, integer: bool = False):
    rng = np.random.default_rng(V_)
    if integer:
        return (rng.integers(-2, 3, (BATCH, DIM)).astype(np.float32), rng.integers(-2, 3, (V_, DIM)).astype(np.float32))
    return rng.standard_normal((BATCH, DIM)).astype(np.float32), rng.standard_normal((V_, DIM)).astype(np.float32)


def _uneven_batch() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Node features [8, 6, 16] whose last three sessions are padding (mask
    off) and the fifth holds one node: the data ranks' valid counts differ."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, 6, DIM)).astype(np.float32)
    mask = np.zeros((BATCH, 6), bool)
    for b, n in enumerate([6, 3, 5, 2, 1, 0, 0, 0]):
        mask[b, :n] = True
    per_sample = rng.standard_normal(BATCH).astype(np.float32)
    return x, mask, per_sample


def _port_model(weights: dict, dropout: float = 0.0):
    model = registry.create_model("graph_transformer_optimized", V, device="cpu", embedding_dim=DIM,
                                  hidden_dim=DIM, laplacian_k=4, dropout=dropout)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# the workers (module level: spawned processes import this file, not JAX)
# ---------------------------------------------------------------------------


def _worker(rank: int, world: int, port: int, task: str, payload: dict, queue) -> None:
    """One rank: the steps task joins through torchrun's variables, the
    Trainer task through the coordinator arguments (both ways of a launch)."""
    import os

    torch.set_num_threads(1)
    try:
        if task == "steps":
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank))
            assert distributed.initialize(device="cpu") and dist.get_backend() == "gloo"
        else:
            distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
        out = {"steps": _steps_task, "trainer": _trainer_task}[task](payload)
        queue.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - the parent reports it
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        distributed.shutdown()


def _spawn(task: str, world: int, payload: dict, attempts: int = 2) -> dict:
    """Run `task` on `world` spawned ranks; rank 0's result. Fails the test on
    a worker's error or after SPAWN_TIMEOUT, and ends every worker. The
    rendezvous port is free when chosen but may be taken before rank 0 binds
    it; only then is the group started again on another port."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = distributed.free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, task, payload, queue)) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(world):
            rank, status, out = queue.get(timeout=SPAWN_TIMEOUT)
            if status != "ok":  # the other ranks may wait for it in a collective: stop them
                errors[rank] = out
                break
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors and attempts > 1 and any("Address already in use" in e for e in errors.values()):
        return _spawn(task, world, payload, attempts - 1)
    for rank, out in errors.items():
        pytest.fail(f"rank {rank} of {task}:\n{out}")
    return results[0]


def _run_steps(model, mesh, mode: str, batches: list, seeds: list) -> dict:
    """The sharded steps of `mode` (eager, lazy, dense) over `batches`, then
    materialize; the losses and the whole state on rank 0. The optimizer
    state is made whole and cut with the model (``shard_params``)."""
    opt = FusedEmbeddingAdamW(**HP, lazy=mode == "lazy")
    model, state = steps.shard_params(model, opt.init(model), mesh)
    loss_fn = create_loss_function("dual")
    make = steps.make_sharded_train_step if mode == "dense" else steps.make_sharded_sparse_train_step
    step = make(model, loss_fn, opt, state, mesh)
    losses = []
    for batch, seed in zip(batches, seeds):
        local = steps.shard_batch(batch, mesh)
        item = local if mode == "dense" else (local, port_batching.to_device(port_batching.make_grad_index(batch), "cpu"))
        losses.append(step(item, seed).item())
    opt.materialize(model, state)
    whole = port_mesh.unshard({**model.state_dict(), **opt.export_state(state, model)}, mesh)
    return {"losses": losses, "state": None if whole is None else _numpy(whole)}


CHAIN_GROUPS = [4, 2, 1]  # a full group, a sub-chain, a single step
CHAIN_ORDER = [0, 1, 2, 0, 1, 2, 0]  # the batches of the seven steps
CHAIN_SEEDS = [20 + i for i in range(len(CHAIN_ORDER))]


def _run_chained(model, mesh, lazy: bool, batches: list, chained: bool) -> dict:
    """Seven sharded sparse steps at CHAIN_SEEDS: one by one, or as
    CHAIN_GROUPS through the chained step (slot i at the unchained step's
    row of the step block); the losses and the whole state on rank 0."""
    opt = FusedEmbeddingAdamW(**HP, lazy=lazy)
    model, state = steps.shard_params(model, opt.init(model), mesh)
    loss_fn = create_loss_function("dual")
    single = steps.make_sharded_sparse_train_step(model, loss_fn, opt, state, mesh)
    chain = steps.make_chained_sharded_sparse_train_step(model, loss_fn, opt, state, mesh)
    group_batches = [batches[i] for i in CHAIN_ORDER]
    losses, i = [], 0
    for size in CHAIN_GROUPS if chained else [1] * len(CHAIN_ORDER):
        group, seeds = group_batches[i:i + size], CHAIN_SEEDS[i:i + size]
        gidxs = [port_batching.make_grad_index(b) for b in group]
        if size == 1:
            losses.append(single((steps.shard_batch(group[0], mesh), port_batching.to_device(gidxs[0], "cpu")),
                                 seeds[0]).item())
        else:
            block = port_trainer.next_steps_block(model, opt, state, seeds, "cpu")
            losses.extend(chain(steps.shard_chained_batch(port_batching.stack_batches(group), mesh),
                                port_batching.to_device(port_batching.stack_grad_indices(gidxs), "cpu"),
                                block).tolist())
        i += size
    opt.materialize(model, state)
    whole = port_mesh.unshard({**model.state_dict(), **opt.export_state(state, model)}, mesh)
    return {"losses": losses, "count": state["count"], "state": None if whole is None else _numpy(whole)}


def _steps_task(p: dict) -> dict:
    n_data, n_model = p["shape"]
    mesh = port_mesh.make_mesh(n_data, n_model, device="cpu")
    d, m = port_mesh.coordinates(mesh)
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
    out = {"coordinates": distributed.allgather(torch.tensor([[dist.get_rank(), d, m]]), dist.group.WORLD)}
    batches = _port_batches()
    for mode, order in (("eager", [0, 1, 2]), ("dense", [0, 1, 2]), ("lazy", [0, 1, 2, 0, 1, 2])):
        out[mode] = _run_steps(_port_model(p["weights"]), mesh, mode, [batches[i] for i in order],
                               [100 + i for i in range(len(order))])
    out["eager_dropout"] = _run_steps(_port_model(p["weights"], dropout=0.1), mesh, "eager", batches, [7, 8, 9])
    out["chained"] = {(mode, chained): _run_chained(_port_model(p["weights"], dropout=0.1), mesh, mode == "lazy",
                                                    batches, chained)
                      for mode in ("eager", "lazy") for chained in (False, True)}
    # The two-phase top-k over this rank's sessions and rows.
    # The eval steps: the GSPMD twin (a dense top-k a shard) and v2 (kernel 2's plain twin).
    model = _port_model(p["weights"])
    port_mesh.shard_model(model, mesh)
    local = steps.shard_batch(batches[0], mesh)
    out["eval"] = {m: distributed.allgather(step(local), data_group) for m, step in (
        ("dense", steps.make_sharded_eval_step(model, 10, mesh)),
        ("two_level", topk.make_sharded_eval_step_v2(model, 10, mesh)))}
    out["topk"] = {}
    for V_, k in TOPK_CASES + [("ties", 5), ("integer", 7)]:
        if V_ == "ties":
            sess, table, num = np.ones((BATCH, 4), np.float32), np.ones((32 * n_model, 4), np.float32), 32 * n_model
        elif V_ == "integer":
            (sess, table), num = _topk_inputs(1224, integer=True), 1224
        else:
            (sess, table), num = _topk_inputs(V_), V_
        whole = topk.pad_rows(torch.from_numpy(table), n_model)
        rows = whole.shape[0] // n_model
        b = BATCH // n_data
        idx, vals = topk.sharded_topk(torch.from_numpy(sess)[d * b:(d + 1) * b], whole[m * rows:(m + 1) * rows],
                                      k, mesh, num)
        out["topk"][V_] = (distributed.allgather(idx, data_group), distributed.allgather(vals, data_group))
    # BatchNorm and the loss's mean at an uneven sample mask, this rank's rows.
    x, mask, per_sample = _uneven_batch()
    b = BATCH // n_data
    rows = slice(d * b, (d + 1) * b)
    xs = torch.from_numpy(x[rows]).requires_grad_(True)
    ps = torch.from_numpy(per_sample[rows]).requires_grad_(True)
    scale = torch.ones(DIM, requires_grad=True)
    buffers = [torch.zeros(DIM), torch.ones(DIM), torch.zeros(())]
    with shard.active(shard.Shard(data_group=data_group, first_session=d * b)):
        y = masked_batch_norm(scale, torch.zeros(DIM), *buffers, xs, torch.from_numpy(mask[rows]), True)
        share = _masked_mean(ps, torch.from_numpy(mask[rows, 0]))
        (y.square().sum() + share).backward()  # the ranks' objectives add up to the whole batch's
    total = share.detach().clone()
    dist.all_reduce(total, group=data_group)
    g_scale = scale.grad.clone()
    dist.all_reduce(g_scale, group=data_group)
    out["bn"] = {"y": distributed.allgather(y.detach(), data_group), "x_grad": distributed.allgather(xs.grad, data_group),
                 "sample_grad": distributed.allgather(ps.grad, data_group), "scale_grad": g_scale.numpy(),
                 "buffers": [t.numpy() for t in buffers], "loss": total.item(),
                 "model_group_size": dist.get_world_size(model_group)}
    return out


def _trainer(model, ds, tmp: str, mesh=None, n_data: int = 1, data_index: int = 0, max_epochs: int = 2,
             chain: int = 1):
    feed = dict(engine="numpy", process_index=data_index, process_count=n_data, with_global_ids=n_data > 1)
    return port_trainer.Trainer(
        model,
        lambda epoch: port_batching.iterate_batches(ds, BATCH, shuffle=True, seed=epoch, **feed),
        lambda: port_batching.iterate_batches(ds, BATCH, **feed),
        optimizer=FusedEmbeddingAdamW(**HP, lazy=True), output_dir=tmp, max_epochs=max_epochs,
        loss_fn=create_loss_function("dual"), sparse_embedding_grads=True, chain=chain, device="cpu", mesh=mesh)


TRAINER_CHAIN = 4  # an epoch: seven batches of node bucket 8 (a full group and three singles), two of 16


def _corpus_columns():
    rng = np.random.default_rng(4)
    lengths = np.clip(rng.geometric(0.25, 60) + 2, 3, 16)
    total = int(lengths.sum())
    sid, ts, items = np.repeat(np.arange(60), lengths), np.arange(total), rng.integers(1, V, total)
    edges = (rng.integers(1, V, 800), rng.integers(1, V, 800))
    return (sid, ts, items), edges


def _corpus():
    columns, edges = _corpus_columns()
    return port_batching.SessionDataset(columns, edges, num_items=V)


def _trainer_task(p: dict) -> dict:
    n_data, n_model = p["shape"]
    mesh = port_mesh.make_mesh(n_data, n_model, device="cpu")
    d, _ = port_mesh.coordinates(mesh)
    t = _trainer(_port_model(p["weights"], dropout=0.1), _corpus(), p["dir"], mesh, n_data, d)
    t.init_state(reset_parameters=False)
    history = t.train()
    # A checkpoint of the one-process run, loaded onto this mesh.
    other = _trainer(_port_model(p["weights"], dropout=0.1), _corpus(), p["single_dir"], mesh, n_data, d)
    other.load_checkpoint("latest")
    loaded = port_mesh.unshard({**other.model.state_dict(),
                                **other.optimizer.export_state(other.opt_state, other.model)}, mesh)
    # The chained mesh Trainer at dropout 0, against the JAX one.
    chained = _trainer(_port_model(p["weights"]), _corpus(), p["chained_dir"], mesh, n_data, d, chain=TRAINER_CHAIN)
    chained.init_state(reset_parameters=False)
    chained_history = chained.train()
    chained_state = port_mesh.unshard({**chained.model.state_dict(),
                                       **chained.optimizer.export_state(chained.opt_state, chained.model)}, mesh)
    return {"history": history, "loaded": None if loaded is None else _numpy(loaded),
            "epoch": other.current_epoch,
            "chained": {"history": chained_history, "dispatches": chained.chained_dispatches,
                        "eval_dispatches": chained.chained_eval_dispatches, "count": chained.opt_state["count"],
                        "state": None if chained_state is None else _numpy(chained_state)}}


# ---------------------------------------------------------------------------
# the pytest process: JAX references and the one-process port
# ---------------------------------------------------------------------------


def _assert_weights_close(got, want, name=""):
    """atol 1e-6 for all but at most 0.05 % of the entries (one entry in a
    tensor of fewer than 2,000), which stay within 2e-5 (2 % of lr): where a
    gradient entry is at rounding-noise level, AdamW's m / (sqrt(v) + eps)
    turns its relative error into a share of lr."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= 2e-5, (name, err.max())
    assert np.sum(err > 1e-6) <= max(1, 5e-4 * err.size), (name, np.argwhere(err > 1e-6), err.max())


@pytest.fixture(scope="module")
def jax_start():
    """The JAX model (PE drawn from a seed), its weights in the port's names."""
    import jax

    from gat_recommendation_torch import convert
    from gat_recommendation_tpu.models import create_model

    model = create_model("graph_transformer_optimized", num_items=V, embedding_dim=DIM, hidden_dim=DIM,
                         laplacian_k=4, dropout=0.0)
    params, state = model.init_params(jax.random.key(0))
    pe = np.random.default_rng(1).normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    pe[V:] = 0.0
    state["cached_pe"] = jax.numpy.asarray(pe)
    numpy_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    weights, buffers = convert.from_jax_params(numpy_tree(params), numpy_tree(state),
                                               dataclasses.asdict(model.config), model.name)
    return model, params, state, _numpy({**weights, **buffers})


def _jax_run(jax_start, shape, mode: str, order: list) -> dict:
    """The JAX sharded step of `mode` on a mesh of `shape` over the 8 CPU
    devices: losses, then the table, moments and last_step after materialize."""
    import jax
    import optax

    from gat_recommendation_tpu.data import batching as ref_batching
    from gat_recommendation_tpu.parallel import make_mesh, make_sharded_sparse_train_step, make_sharded_train_step
    from gat_recommendation_tpu.parallel.steps import shard_batch, shard_params
    from gat_recommendation_tpu.train.losses import create_loss_function as jax_loss
    from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

    model, params, state, _ = jax_start
    mesh = make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
    if mode == "dense":
        opt = optax.adamw(1e-3, weight_decay=1e-5)
        step = make_sharded_train_step(model, jax_loss("dual"), opt, mesh)
    else:
        opt = JaxOptimizer(**HP, use_pallas=False, lazy=mode == "lazy")
        step = make_sharded_sparse_train_step(model, jax_loss("dual"), opt, mesh)
    p, s, o = shard_params(params, state, opt.init(params), mesh)
    batches = [ref_batching.collate(_samples(seed), 8, K) for seed in BATCH_SEEDS]
    losses = []
    for i, b in enumerate(order):
        p, s, o, loss = step(p, s, o, shard_batch(batches[b], mesh), jax.random.key(100 + i))
        losses.append(float(loss))
    if mode == "lazy":
        p, o = opt.materialize(p, o)
    return {"losses": losses, "params": jax.tree.map(np.asarray, p), "state": jax.tree.map(np.asarray, s),
            "opt": jax.tree.map(np.asarray, o)}


def _one_process(weights: dict, mode: str, order: list, seeds: list, dropout: float = 0.0) -> dict:
    """The port's one-process steps from the same weights."""
    model = _port_model(weights, dropout)
    opt = FusedEmbeddingAdamW(**HP, lazy=mode == "lazy")
    state = opt.init(model)
    make = port_trainer.make_train_step if mode == "dense" else port_trainer.make_sparse_train_step
    step = make(model, create_loss_function("dual"), opt, state)
    batches = _port_batches()
    losses = [step(batches[b], seed).item() for b, seed in zip(order, seeds)]
    opt.materialize(model, state)
    return {"losses": losses, "state": _numpy({**model.state_dict(), **opt.export_state(state, model)})}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, jax_start):
    """One spawn a mesh shape: every check's results of rank 0."""
    shape = request.param
    return shape, _spawn("steps", shape[0] * shape[1], {"shape": shape, "weights": jax_start[3]})


ORDERS = {"eager": [0, 1, 2], "dense": [0, 1, 2], "lazy": [0, 1, 2, 0, 1, 2]}


def test_mesh_lays_ranks_out_row_major(mesh_run):
    (n_data, n_model), out = mesh_run
    coords = out["coordinates"]
    for rank, d, m in coords:
        assert (d, m) == (rank // n_model, rank % n_model)
    assert out["bn"]["model_group_size"] == n_model


def _check_against_port(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for name, w in want["state"].items():
        if NOISE_GRADIENT.search(name):
            continue
        if name.startswith("rest.") or name in ("emb_mu", "emb_nu"):
            np.testing.assert_allclose(got["state"][name], w, rtol=0, atol=MOMENT_ATOL, err_msg=name)
        elif name == "last_step" or name.endswith("count"):
            np.testing.assert_array_equal(got["state"][name], w, err_msg=name)
        else:
            _assert_weights_close(got["state"][name], w, name)


def _check_against_jax(got: dict, want: dict, start) -> None:
    """Loss, table, moments, last_step and every other weight (as convert
    maps the JAX tree) of the port's sharded run against the JAX one."""
    import jax

    from gat_recommendation_torch import convert

    model = start[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    weights, buffers = convert.from_jax_params(want["params"], want["state"], dataclasses.asdict(model.config),
                                               model.name)
    for name, w in {**weights, **buffers}.items():
        if NOISE_GRADIENT.search(name):
            continue
        if name.startswith("batch_norms."):
            np.testing.assert_allclose(got["state"][name], w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            _assert_weights_close(got["state"][name], w.numpy(), name)
    opt = want["opt"]
    if isinstance(opt, dict):  # the fused optimizer's state: the table's moments and count
        for key in ("emb_mu", "emb_nu"):
            np.testing.assert_allclose(got["state"][key], np.asarray(opt[key]), rtol=0, atol=MOMENT_ATOL, err_msg=key)
        if "last_step" in opt:
            np.testing.assert_array_equal(got["state"]["last_step"], np.asarray(opt["last_step"]))
    else:  # optax.adamw: the table's first and second moments
        adam = next(s for s in jax.tree.leaves(opt, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
        np.testing.assert_allclose(got["state"]["emb_mu"], np.asarray(adam.mu["item_embedding"]), rtol=0,
                                   atol=MOMENT_ATOL)
        np.testing.assert_allclose(got["state"]["emb_nu"], np.asarray(adam.nu["item_embedding"]), rtol=0,
                                   atol=MOMENT_ATOL)


@pytest.mark.parametrize("mode", ["eager", "lazy", "dense"])
def test_sharded_step_matches_the_jax_sharded_step(mesh_run, jax_start, mode):
    shape, out = mesh_run
    _check_against_jax(out[mode], _jax_run(jax_start, shape, mode, ORDERS[mode]), jax_start)


@pytest.mark.parametrize("mode", ["eager", "lazy", "dense"])
def test_sharded_step_matches_the_one_process_step(mesh_run, jax_start, mode):
    _, out = mesh_run
    order = ORDERS[mode]
    _check_against_port(out[mode], _one_process(jax_start[3], mode, order, [100 + i for i in range(len(order))]))


def test_sharded_step_with_dropout_matches_the_one_process_step(mesh_run, jax_start):
    """Dropout 0.1: the data ranks' node and attention dropout draw the whole
    batch's bits at their rows, so the sharded trajectory is the one-process
    one."""
    _, out = mesh_run
    _check_against_port(out["eager_dropout"], _one_process(jax_start[3], "eager", [0, 1, 2], [7, 8, 9], 0.1))


@pytest.mark.parametrize("mode", ["eager", "lazy"])
def test_chained_sharded_step_equals_the_unchained_one_bit_for_bit(mesh_run, mode):
    """Dropout 0.1; a group of 4, a sub-chain of 2 and a single step against
    seven single steps: losses, the optimizer's count and every tensor of
    the state EQUAL (a chained slot is the unchained step with its row)."""
    _, out = mesh_run
    want, got = out["chained"][(mode, False)], out["chained"][(mode, True)]
    assert got["losses"] == want["losses"] and got["count"] == want["count"] == len(CHAIN_ORDER)
    assert set(got["state"]) == set(want["state"]) and len(want["state"]) > 10
    for name, w in want["state"].items():
        np.testing.assert_array_equal(got["state"][name], w, err_msg=name)


def test_sharded_topk_ids_equal_the_jax_sharded_topk(mesh_run):
    import jax
    import jax.numpy as jnp

    from gat_recommendation_tpu.parallel import make_mesh
    from gat_recommendation_tpu.parallel.topk import sharded_topk

    shape, out = mesh_run
    jmesh = make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
    for V_, k in TOPK_CASES + [("integer", 7)]:
        sess, table = _topk_inputs(1224, integer=True) if V_ == "integer" else _topk_inputs(V_)
        want_idx, want_vals = sharded_topk(jnp.asarray(sess), jnp.asarray(table), k, jmesh)
        got_idx, got_vals = out["topk"][V_]
        np.testing.assert_array_equal(got_idx, np.asarray(want_idx), err_msg=str(V_))
        np.testing.assert_allclose(got_vals, np.asarray(want_vals), rtol=1e-5, err_msg=str(V_))
    n_model = shape[1]
    want_idx, _ = sharded_topk(jnp.ones((BATCH, 4)), jnp.ones((32 * n_model, 4)), 5, jmesh)
    np.testing.assert_array_equal(out["topk"]["ties"][0], np.asarray(want_idx))  # every score equal
    dense = (_topk_inputs(20)[0] @ _topk_inputs(20)[1].T)
    assert np.all(out["topk"][20][0] < 20)  # padding rows never win
    np.testing.assert_array_equal(out["topk"][20][0], np.argsort(-dense, axis=1, kind="stable")[:, :5])


def test_sharded_eval_steps_give_the_jax_eval_steps_ids(mesh_run, jax_start):
    """Both sharded eval steps (the forward with the table and encodings
    read through the model group, then the two-phase top-k) give the top-10
    ids of the JAX package's single-device eval step, and of the port's."""
    from gat_recommendation_tpu.data import batching as ref_batching
    from gat_recommendation_tpu.train.trainer import make_eval_step

    _, out = mesh_run
    model, params, state, weights = jax_start
    want = np.asarray(make_eval_step(model, 10)(params, state, ref_batching.to_device(
        ref_batching.collate(_samples(BATCH_SEEDS[0]), 8, K))))
    port = port_trainer.make_eval_step(_port_model(weights), 10)(_port_batches()[0]).numpy()
    np.testing.assert_array_equal(port, want)
    for method, got in out["eval"].items():
        np.testing.assert_array_equal(got, want, err_msg=method)


def test_sharded_topk_breaks_ties_by_the_lowest_index(mesh_run):
    _, out = mesh_run
    np.testing.assert_array_equal(out["topk"]["ties"][0], [[0, 1, 2, 3, 4]] * BATCH)


def test_batch_norm_and_loss_take_the_global_batch_at_an_uneven_mask(mesh_run):
    """The ranks' outputs, input gradients, scale gradient (summed),
    running buffers and loss shares (summed) equal the one-process ones,
    though one data rank's slots are mostly padding."""
    _, out = mesh_run
    x, mask, per_sample = _uneven_batch()
    assert mask[:, 0].sum() == 5 and mask[4:, 0].sum() == 1  # 4 valid sessions in the first half, 1 in the second
    xs = torch.from_numpy(x).requires_grad_(True)
    ps = torch.from_numpy(per_sample).requires_grad_(True)
    scale = torch.ones(DIM, requires_grad=True)
    buffers = [torch.zeros(DIM), torch.ones(DIM), torch.zeros(())]
    y = masked_batch_norm(scale, torch.zeros(DIM), *buffers, xs, torch.from_numpy(mask), True)
    loss = _masked_mean(ps, torch.from_numpy(mask[:, 0]))
    (y.square().sum() + loss).backward()
    bn = out["bn"]
    np.testing.assert_allclose(bn["y"], y.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn["x_grad"], xs.grad.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn["sample_grad"], ps.grad.numpy(), rtol=1e-6)  # 1 / the global valid count
    np.testing.assert_allclose(bn["scale_grad"], scale.grad.numpy(), rtol=1e-5, atol=1e-5)
    for got, want in zip(bn["buffers"], buffers):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-7)
    assert bn["loss"] == pytest.approx(loss.item(), rel=1e-6)


# ---------------------------------------------------------------------------
# the Trainer over a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_trainer(jax_start, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("single")
    t = _trainer(_port_model(jax_start[3], dropout=0.1), _corpus(), str(tmp))
    t.init_state(reset_parameters=False)
    history = t.train()
    state = _numpy({**t.model.state_dict(), **t.optimizer.export_state(t.opt_state, t.model)})
    return str(tmp), history, state


@pytest.fixture(scope="module", params=[(2, 1), (1, 2)], ids=["2x1", "1x2"])
def trainer_run(request, jax_start, single_trainer, tmp_path_factory):
    """One 2-process spawn a mesh shape: the Trainer runs of rank 0 (at
    dropout 0.1 against the one-process Trainer, and the chained one at
    dropout 0 against the JAX Trainer)."""
    shape = request.param
    out_dir = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
    out = _spawn("trainer", 2, {"shape": shape, "weights": jax_start[3], "dir": str(out_dir / "plain"),
                                "chained_dir": str(out_dir / "chained"), "single_dir": single_trainer[0]})
    return shape, out_dir / "plain", out


def test_trainer_over_a_mesh_equals_the_one_process_trainer(trainer_run, jax_start, single_trainer):
    """Two epochs of lazy sparse steps at dropout 0.1 with an evaluation
    after each: losses 1e-5, metrics equal; the mesh's checkpoint is the
    one-process file, and loads on one process with the one-process state
    (1e-6); the one-process checkpoint loads on the mesh."""
    single_dir, history, state = single_trainer
    _, out_dir, out = trainer_run
    np.testing.assert_allclose(out["history"]["train_loss"], history["train_loss"], rtol=LOSS_RTOL)
    for got, want in zip(out["history"]["val_metrics"], history["val_metrics"]):
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=1e-9), key
    assert (out_dir / "history.json").exists() and (out_dir / "checkpoint_best").exists()
    reader = _trainer(_port_model(jax_start[3], dropout=0.1), _corpus(), str(out_dir))
    reader.load_checkpoint("latest")
    assert reader.current_epoch == 2 and reader.history["train_loss"] == out["history"]["train_loss"]
    loaded = {"losses": [], "state": _numpy({**reader.model.state_dict(),
                                             **reader.optimizer.export_state(reader.opt_state, reader.model)})}
    _check_against_port(loaded, {"losses": [], "state": state})
    assert out["epoch"] == 2
    for name, w in state.items():
        np.testing.assert_array_equal(out["loaded"][name], w, err_msg=name)  # the bytes of the file


def _jax_chained_trainer(jax_start, shape, out_dir):
    """The JAX Trainer on a mesh of `shape` at chain TRAINER_CHAIN from the
    start weights, lazy, dropout 0: its history and final (params, state,
    opt_state)."""
    import jax
    import pandas as pd

    from gat_recommendation_tpu.data import batching as ref_batching
    from gat_recommendation_tpu.parallel import make_mesh
    from gat_recommendation_tpu.train.losses import create_loss_function as jax_loss
    from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer
    from gat_recommendation_tpu.train.trainer import Trainer as JaxTrainer

    model, params, state, _ = jax_start
    (sid, ts, items), edges = _corpus_columns()
    ds = ref_batching.SessionDataset(pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": items}), edges,
                                     num_items=V)
    trainer = JaxTrainer(
        model, lambda epoch: ref_batching.iterate_batches(ds, BATCH, shuffle=True, seed=epoch, engine="numpy"),
        lambda: ref_batching.iterate_batches(ds, BATCH, engine="numpy"),
        optimizer=JaxOptimizer(**HP, use_pallas=False, lazy=True), output_dir=out_dir, max_epochs=2,
        loss_fn=jax_loss("dual"), sparse_embedding_grads=True, chain=TRAINER_CHAIN,
        mesh=make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]]))
    params, state = (jax.tree.map(lambda x: jax.numpy.array(x, copy=True), t) for t in (params, state))
    history = trainer.train(params, state, trainer.optimizer.init(params))  # donates its copies
    p, s, o = trainer._final
    return trainer, history, {"params": jax.tree.map(np.asarray, p), "state": jax.tree.map(np.asarray, s),
                              "opt": jax.tree.map(np.asarray, o)}


def test_chained_trainer_over_a_mesh_matches_the_jax_chained_mesh_trainer(trainer_run, jax_start, tmp_path):
    """The port's twin of the JAX package's
    ``test_sharded_chained_step_matches_unchained``: two epochs at
    ``chain=4`` on the mesh, lazy, dropout 0, against the JAX mesh Trainer at
    ``chain=4`` on as many virtual CPU devices: losses 1e-5 relative, metrics
    1e-9, the table, moments, ``last_step`` and every other weight as
    ``_check_against_jax``; the same chained dispatches, none in evaluation."""
    shape, _, out = trainer_run
    got = out["chained"]
    jt, want, final = _jax_chained_trainer(jax_start, shape, tmp_path)
    assert got["dispatches"] == jt.chained_dispatches == 2 and got["eval_dispatches"] == 0
    assert got["count"] == 18  # nine steps an epoch, chained or not
    for g, w in zip(got["history"]["val_metrics"], want["val_metrics"], strict=True):
        assert set(g) == set(w)
        for key, value in w.items():
            assert g[key] == pytest.approx(value, abs=1e-9), key
    _check_against_jax({"losses": got["history"]["train_loss"], "state": got["state"]},
                       {"losses": want["train_loss"], **final}, jax_start)


# ---------------------------------------------------------------------------
# dropout counters of a data rank (no spawn)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_data", [2, 4])
def test_node_dropout_of_a_data_rank_draws_the_whole_batchs_bits_at_its_rows(n_data):
    """A rank's rows of [8, 6, 16] node features, dropped with the counter
    offset of its first session (given, or from the active shard), equal the
    same rows of the whole batch's draw, forward and backward."""
    from gat_recommendation_torch.ops.node_dropout import node_dropout

    gen = torch.Generator().manual_seed(3)
    x, g = torch.randn(BATCH, 6, DIM, generator=gen), torch.randn(BATCH, 6, DIM, generator=gen)
    seed = 2**63 + 99
    whole = node_dropout(x, 0.3, seed)
    assert 0 < (whole == 0).float().mean() < 0.6
    b = BATCH // n_data
    for d in range(n_data):
        rows = slice(d * b, (d + 1) * b)
        assert torch.equal(node_dropout(x[rows], 0.3, seed, offset=d * b * 6 * DIM), whole[rows])
        leaf = x[rows].clone().requires_grad_(True)
        with shard.active(shard.Shard(first_session=d * b)):
            part = node_dropout(leaf, 0.3, seed)
        (grad,) = torch.autograd.grad(part, leaf, g[rows])
        assert torch.equal(part.detach(), whole[rows])
        assert torch.equal(grad, node_dropout(g, 0.3, seed)[rows])


@pytest.mark.parametrize("packed", [False, True])
def test_attention_dropout_of_a_data_rank_draws_the_whole_batchs_bits_at_its_rows(packed):
    """Session b of a rank whose first session is b0 draws the bits of
    session b0 + b: its output and input gradients equal the whole batch's at
    those sessions (float32, the attention tolerance)."""
    from gat_recommendation_torch.ops.session_attention import session_attention

    gen = torch.Generator().manual_seed(4)
    q, k, v, dout = (torch.randn(BATCH, 8, DIM, generator=gen) for _ in range(4))
    adj = torch.rand(BATCH, 8, 8, generator=gen) < 0.5
    if packed:
        adj = torch.from_numpy(np.packbits(adj.numpy(), axis=-1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    whole = session_attention(*leaves, adj, 2, 0.3, 1234, packed=packed)
    grads = torch.autograd.grad(whole, leaves, dout)
    for d in range(2):
        rows = slice(d * 4, (d + 1) * 4)
        part_leaves = [t[rows].clone().requires_grad_(True) for t in (q, k, v)]
        with shard.active(shard.Shard(first_session=d * 4)):
            part = session_attention(*part_leaves, adj[rows], 2, 0.3, 1234, packed=packed)
        part_grads = torch.autograd.grad(part, part_leaves, dout[rows])
        torch.testing.assert_close(part, whole[rows], rtol=1e-5, atol=1e-5)
        for got, want in zip(part_grads, grads):
            torch.testing.assert_close(got, want[rows], rtol=1e-5, atol=2e-5)
        assert torch.equal(part == 0, whole[rows] == 0)
    other = session_attention(q[4:], k[4:], v[4:], adj[4:], 2, 0.3, 1234, packed=packed, first_session=0)
    assert not torch.equal(other == 0, whole[4:] == 0)  # without the offset the bits differ
