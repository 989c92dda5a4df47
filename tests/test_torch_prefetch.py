"""The port's ``prefetch_to_device`` and ``Trainer(transfer_workers=)`` on the CPU.

``prefetch_to_device`` mirrors the JAX package's (``tests/test_batching.py``'s
prefetch cases): items come out in the iterator's order with one transfer
thread and with a pool, a transfer's or the iterator's error is raised in the
consumer, and an abandoned generator releases its threads. On the CPU there
is no side stream; the card's cases are in ``test_torch_kernels_on_card.py``.

The Trainer's epoch goes through it: ``Trainer(transfer_workers=3)`` at chain
1 and chain 4, with the epoch assembled on a pool, gives the losses, history
and state of ``transfer_workers=1`` with inline assembly bit for bit (dropout
on), and at dropout 0 matches the JAX ``Trainer(transfer_workers=3)`` within
the trajectory tolerances of ``tests/test_torch_chain.py`` (train losses 1e-5
relative, metrics 1e-9).
"""

import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch import convert
from gat_recommendation_torch.data import batching as port_batching
from gat_recommendation_torch.data.batching import prefetch_to_device
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.train import trainer as port_trainer
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_tpu.data import batching as ref_batching
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.train import trainer as ref_trainer
from gat_recommendation_tpu.train.losses import create_loss_function as jax_create_loss
from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

torch.set_num_threads(1)

V, DIM, BATCH = 300, 32, 16
HP = dict(learning_rate=1e-3, weight_decay=1e-5)


def _wait_for_threads(before: int) -> None:
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before, "prefetch leaked a thread"


@pytest.mark.parametrize("transfer_workers", [1, 3])
def test_prefetch_keeps_the_iterators_order(transfer_workers):
    out = list(prefetch_to_device(iter(range(50)), size=4, device="cpu", transfer_workers=transfer_workers,
                                  transfer=lambda x: (time.sleep(0.001 * (x % 3)), x * 2)[1]))
    assert out == [x * 2 for x in range(50)]


@pytest.mark.parametrize("transfer_workers", [1, 2])
def test_a_transfer_error_is_raised_in_the_consumer(transfer_workers):
    def bad_transfer(x):
        if x == 5:
            raise ValueError("boom")
        return x

    got = []
    with pytest.raises(ValueError, match="boom"):
        for x in prefetch_to_device(iter(range(10)), size=2, transfer=bad_transfer,
                                    transfer_workers=transfer_workers, device="cpu"):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def test_an_iterator_error_is_raised_in_the_consumer():
    def source():
        yield 1
        raise KeyError("source")

    gen = prefetch_to_device(source(), transfer=lambda x: x, device="cpu")
    assert next(gen) == 1
    with pytest.raises(KeyError, match="source"):
        next(gen)


@pytest.mark.parametrize("transfer_workers", [1, 2])
def test_an_abandoned_prefetch_releases_its_threads(transfer_workers):
    produced = []

    def source():
        for i in range(100):
            produced.append(i)
            yield i

    before = threading.active_count()
    gen = prefetch_to_device(source(), size=2, transfer=lambda x: x, transfer_workers=transfer_workers,
                             device="cpu")
    assert next(gen) == 0
    gen.close()  # abandoned mid-epoch
    _wait_for_threads(before)
    assert len(produced) < 100  # the worker stopped, it did not drain the source


def test_the_default_transfer_moves_batches_and_indexes(tmp_path):
    rng = np.random.default_rng(0)
    lengths = rng.integers(3, 9, 60)
    sid = np.repeat(np.arange(60), lengths)
    ds = port_batching.SessionDataset((sid, np.arange(len(sid)), rng.integers(1, 50, len(sid))),
                                      (rng.integers(1, 50, 200), rng.integers(1, 50, 200)), num_items=50)
    host = list(port_batching.iterate_batches(ds, 8, engine="numpy"))
    items = [(b, port_batching.make_grad_index(b)) for b in host]
    moved = list(prefetch_to_device(iter(items), device="cpu", transfer_workers=2))
    assert len(moved) == len(items)
    for (batch, gidx), (b, g) in zip(moved, items):
        assert torch.equal(batch.adj, b.adj) and torch.equal(gidx.uid, torch.from_numpy(g.uid))


def test_prefetch_asks_for_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter(range(3))))


def test_prefetch_under_thread_switching_stress():
    """More transfer threads than cores, a switch interval of 10 µs: order
    and every item kept over 2,000 items."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = list(prefetch_to_device(iter(range(2000)), size=3, transfer=lambda x: [x] * 3,
                                      transfer_workers=16, device="cpu"))
    finally:
        sys.setswitchinterval(interval)
    assert out == [[x] * 3 for x in range(2000)]


# -- the Trainer ------------------------------------------------------------


def _corpus(seed=0, sessions=150, max_events=14):
    """Two node buckets; ten-odd batches of 16 an epoch."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, max_events, sessions)
    total = int(lengths.sum())
    sid, ts = np.repeat(np.arange(sessions), lengths), np.arange(total)
    items = rng.integers(1, V, total)
    edges = (rng.integers(1, V, 6000), rng.integers(1, V, 6000))
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": items})
    return (ref_batching.SessionDataset(df, edges, num_items=V),
            port_batching.SessionDataset((sid, ts, items), edges, num_items=V))


def _jax_model(dropout=0.0):
    model = jax_create_model("graph_transformer_optimized", num_items=V, embedding_dim=DIM, hidden_dim=DIM,
                             laplacian_k=4, dropout=dropout)
    params, state = model.init_params(jax.random.key(0))
    pe = np.random.default_rng(0).normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    pe[V:] = 0.0
    state["cached_pe"] = jnp.asarray(pe)
    return model, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _port_model(jax_model, params, state):
    cfg = dataclasses.asdict(jax_model.config)
    model = registry.create_model(jax_model.name, cfg.pop("num_items"), device="cpu", **cfg)
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(jax_model.config))
    model.load_state_dict({**weights, **buffers})
    return model


def _port_trainer(ds, model, out, chain, workers, transfer_workers):
    return port_trainer.Trainer(
        model,
        lambda epoch: port_batching.iterate_batches(ds, BATCH, shuffle=True, seed=epoch, engine="numpy",
                                                    workers=workers),
        lambda: port_batching.iterate_batches(ds, BATCH, engine="numpy"),
        optimizer=FusedEmbeddingAdamW(**HP, lazy=True), output_dir=out, max_epochs=2,
        loss_fn=create_loss_function("dual"), sparse_embedding_grads=True, chain=chain,
        transfer_workers=transfer_workers, device="cpu")


def _state_tensors(trainer):
    s = trainer.opt_state
    rest = [t for p in s["rest"].state.values() for t in p.values()]
    return [*trainer.model.state_dict().values(), s["emb_mu"], s["emb_nu"], s["last_step"], *rest]


@pytest.mark.parametrize("chain", [1, 4])
def test_pipelined_trainer_equals_the_inline_one_bit_for_bit(tmp_path, chain):
    """Dropout 0.1: the pipelined epoch (assembly on 3 threads, 3 transfer
    threads) is the inline one (no pool, one transfer thread), seed for seed."""
    _, port_ds = _corpus()
    jax_model, params, state = _jax_model(dropout=0.1)
    runs = []
    for workers, transfer_workers in ((0, 1), (3, 3)):
        trainer = _port_trainer(port_ds, _port_model(jax_model, params, state), tmp_path / str(workers), chain,
                                workers, transfer_workers)
        runs.append((trainer, trainer.train()))
    (plain, want), (piped, got) = runs
    assert got == want and len(got["train_loss"]) == 2
    assert (piped.chained_dispatches > 0) == (chain > 1) and piped.chained_dispatches == plain.chained_dispatches
    for a, b in zip(_state_tensors(piped), _state_tensors(plain), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chain", [1, 4])
def test_pipelined_trainer_matches_the_jax_trainer(tmp_path, chain):
    jax_ds, port_ds = _corpus()
    jax_model, params, state = _jax_model()
    port = _port_trainer(port_ds, _port_model(jax_model, params, state), tmp_path / "port", chain, 3, 3)
    port.init_state(reset_parameters=False)
    jt = ref_trainer.Trainer(
        jax_model,
        lambda epoch: ref_batching.iterate_batches(jax_ds, BATCH, shuffle=True, seed=epoch, engine="numpy",
                                                   workers=3),
        lambda: ref_batching.iterate_batches(jax_ds, BATCH, engine="numpy"),
        optimizer=JaxOptimizer(**HP, use_pallas=False, lazy=True), output_dir=tmp_path / "jax", max_epochs=2,
        loss_fn=jax_create_loss("dual"), sparse_embedding_grads=True, chain=chain, transfer_workers=3)
    params, state = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    want = jt.train(params, state, jt.optimizer.init(params))
    got = port.train()
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    for g, w in zip(got["val_metrics"], want["val_metrics"], strict=True):
        assert set(g) == set(w)
        for key, value in w.items():
            assert g[key] == pytest.approx(value, abs=1e-9), key
    assert port.chained_dispatches == jt.chained_dispatches
