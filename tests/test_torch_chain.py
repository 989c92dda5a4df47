"""The port's chained training and evaluation (``Trainer(chain=C)``) on the CPU.

Against the JAX package: ``chain_iterator``, ``stack_batches`` and
``stack_grad_indices`` give EQUAL arrays (the port's GradIndex also carries
``lengths``, zero-padded with the sentinel slots); ``Trainer(chain=C)``
trains like the JAX Trainer with the same chain, lazy and eager sparse, at
dropout 0 (train losses 1e-5 relative, metrics 1e-9, as in
``tests/test_torch_trainer_train.py``). The corpus gives ten batches of one
node bucket an epoch: C = 4 runs two full groups and two single steps, C = 12
one SUBCHAIN of eight and two single steps.

Against itself: a chained run is the unchained program, step for step and
seed for seed, so with dropout on its losses, table, moments, ``last_step``,
other parameters and BatchNorm buffers are EQUAL to the unchained run's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch import convert
from gat_recommendation_torch.data import batching as port_batching
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
BATCH_FIELDS = ("node_ids", "node_mask", "adj", "num_nodes", "targets", "negatives", "sample_mask")


def _corpus(seed=0, sessions=160, max_events=10):
    """Sessions of 3 .. max_events - 1 events (at most 8 context nodes: one
    bucket below 10 events)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, max_events, sessions)
    total = int(lengths.sum())
    sid, ts = np.repeat(np.arange(sessions), lengths), np.arange(total)
    items = rng.integers(1, V, total)
    edges = (rng.integers(1, V, 6000), rng.integers(1, V, 6000))
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": items})
    return (ref_batching.SessionDataset(df, edges, num_items=V),
            port_batching.SessionDataset((sid, ts, items), edges, num_items=V))


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _jax_model(seed=0, name="graph_transformer_optimized"):
    kw = {"laplacian_k": 4} if name.startswith("graph_transformer") else {}
    model = jax_create_model(name, num_items=V, embedding_dim=DIM, hidden_dim=DIM, dropout=0.0, **kw)
    params, state = model.init_params(jax.random.key(seed))
    if "cached_pe" in state:
        pe = np.random.default_rng(seed).normal(0, 1, state["cached_pe"].shape).astype(np.float32)
        pe[V:] = 0.0
        state["cached_pe"] = jnp.asarray(pe)
    return model, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _port_model(jax_model, params, state, **overrides):
    cfg = {**dataclasses.asdict(jax_model.config), **overrides}
    model = registry.create_model(jax_model.name, cfg.pop("num_items"), device="cpu", **cfg)
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(jax_model.config), jax_model.name)
    model.load_state_dict({**weights, **buffers})
    return model


def _port_batches(ds, epoch=None):
    if epoch is None:
        return port_batching.iterate_batches(ds, BATCH, engine="numpy")
    return port_batching.iterate_batches(ds, BATCH, shuffle=True, seed=epoch, engine="numpy")


def test_chain_grouping_and_stacking_equal_the_jax_packages(corpus):
    jax_ds, port_ds = _corpus(sessions=120, max_events=20)  # several node buckets: groups end at the boundaries
    jax_groups = list(ref_batching.chain_iterator(ref_batching.iterate_batches(jax_ds, BATCH, engine="numpy"), 3))
    port_groups = list(port_batching.chain_iterator(_port_batches(port_ds), 3))
    assert [len(g) for g in port_groups] == [len(g) for g in jax_groups]
    assert len({g[0].nodes_per_session for g in port_groups}) > 1 and min(map(len, port_groups)) < 3
    for jg, pg in zip(jax_groups, port_groups):
        want, got = ref_batching.stack_batches(jg), port_batching.stack_batches(pg)
        for f in BATCH_FIELDS:
            assert np.array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy()), f
        p_idx = [port_batching.make_grad_index(b) for b in pg]
        want_idx = ref_batching.stack_grad_indices([ref_batching.make_grad_index(b) for b in jg])
        got_idx = port_batching.stack_grad_indices(p_idx)
        for f in ("ids", "perm", "seg", "uid"):
            assert np.array_equal(getattr(want_idx, f), getattr(got_idx, f)), f
        U = got_idx.uid.shape[1]
        for i, g in enumerate(p_idx):  # lengths: each index's own, then zeros for the sentinel slots
            assert np.array_equal(got_idx.lengths[i], np.concatenate([g.lengths, np.zeros(U - len(g.uid), np.int64)]))
        assert np.array_equal(got_idx.lengths.sum(1), np.full(len(pg), got_idx.ids.shape[1]))


def _jax_trainer(corpus, jax_model, out, chain, lazy):
    jax_ds, _ = corpus
    return ref_trainer.Trainer(
        jax_model,
        lambda epoch: ref_batching.iterate_batches(jax_ds, BATCH, shuffle=True, seed=epoch, engine="numpy"),
        lambda: ref_batching.iterate_batches(jax_ds, BATCH, engine="numpy"),
        optimizer=JaxOptimizer(**HP, use_pallas=False, lazy=lazy), output_dir=out, max_epochs=2,
        loss_fn=jax_create_loss("dual"), sparse_embedding_grads=True, chain=chain)


def _port_trainer(port_ds, model, out, chain, lazy, **kw):
    trainer = port_trainer.Trainer(
        model, lambda epoch: _port_batches(port_ds, epoch), lambda: _port_batches(port_ds),
        optimizer=FusedEmbeddingAdamW(**HP, lazy=lazy), output_dir=out, max_epochs=2,
        loss_fn=create_loss_function("dual"), sparse_embedding_grads=True, chain=chain, device="cpu", **kw)
    trainer.init_state(reset_parameters=False)
    return trainer


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("chain", [1, 4, 12])
def test_chained_trainer_matches_the_jax_trainer(corpus, tmp_path, chain, lazy):
    jax_model, params, state = _jax_model()
    port = _port_trainer(corpus[1], _port_model(jax_model, params, state), tmp_path / "port", chain, lazy)
    jt = _jax_trainer(corpus, jax_model, tmp_path / "jax", chain, lazy)
    params, state = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    want = jt.train(params, state, jt.optimizer.init(params))
    got = port.train()
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    for g, w in zip(got["val_metrics"], want["val_metrics"], strict=True):
        assert set(g) == set(w)
        for key, value in w.items():
            assert g[key] == pytest.approx(value, abs=1e-9), key
    assert port.chained_dispatches == jt.chained_dispatches
    assert port.chained_eval_dispatches == jt.chained_eval_dispatches
    assert (port.chained_dispatches > 0) == (chain > 1)
    assert port.opt_state["count"] == 20  # ten steps an epoch, chained or not


def _state_tensors(trainer):
    s = trainer.opt_state
    rest = [t for p in s["rest"].state.values() for t in p.values()]
    table_state = [s[k] for k in ("emb_mu", "emb_nu", "last_step") if k in s]
    return [*trainer.model.state_dict().values(), *table_state, *rest]


@pytest.mark.parametrize("lazy", [True, False])
def test_chained_run_equals_the_unchained_run_exactly_with_dropout(tmp_path, lazy):
    """Two node buckets, dropout 0.1 (attention and nodes), chain 4: full
    groups, a group cut at the bucket boundary, single steps."""
    _, port_ds = _corpus(sessions=150, max_events=14)
    jax_model, params, state = _jax_model()
    runs = {}
    for chain in (1, 4):
        model = registry.create_model(jax_model.name, V, device="cpu", embedding_dim=DIM, hidden_dim=DIM,
                                      laplacian_k=4, dropout=0.1)
        model.load_state_dict(_port_model(jax_model, params, state).state_dict())
        trainer = _port_trainer(port_ds, model, tmp_path / str(chain), chain, lazy)
        runs[chain] = (trainer, trainer.train())
    (plain, want), (chained, got) = runs[1], runs[4]
    assert chained.chained_dispatches > 0 and chained.chained_eval_dispatches > 0
    assert plain.chained_dispatches == plain.chained_eval_dispatches == 0
    assert got == want  # losses and metrics, as floats
    assert chained.opt_state["count"] == plain.opt_state["count"]
    for a, b in zip(_state_tensors(chained), _state_tensors(plain), strict=True):
        assert torch.equal(a, b)


def _frozen_conv_bias(jax_model, port_model):
    """Both packages' GAT with the conv biases held at their initial zeros.

    Each conv bias feeds a BatchNorm at once, so its gradient is zero but for
    rounding, and AdamW turns that rounding into steps of about lr whose
    signs differ between the packages; eval mode sees the bias minus the
    running mean, where near ties in the scores can then order differently.
    Held at zero (a stopped gradient in JAX, a buffer in the port), the bias
    takes no step in either package, and every other weight follows the
    same trajectory."""

    def apply(params, state, batch, cfg, **kw):
        convs = [{**c, "bias": jax.lax.stop_gradient(c["bias"])} for c in params["convs"]]
        return jax_model.apply({**params, "convs": convs}, state, batch, cfg, **kw)

    for conv in port_model.convs:
        bias = conv.bias.detach().clone()
        assert not bias.any()
        del conv.bias
        conv.register_buffer("bias", bias)
    return dataclasses.replace(jax_model, apply=apply), port_model


def test_chained_gat_trainer_matches_the_jax_trainer(corpus, tmp_path):
    """GAT (3 layers, 4 heads) through the lazy Trainer at chain 4, against
    the JAX Trainer with the same chain: train losses 1e-5, metrics 1e-9,
    with the conv biases held at zero in both (``_frozen_conv_bias``)."""
    jax_model, params, state = _jax_model(name="gat")
    jax_model, model = _frozen_conv_bias(jax_model, _port_model(jax_model, params, state))
    port = _port_trainer(corpus[1], model, tmp_path / "port", 4, True)
    jt = _jax_trainer(corpus, jax_model, tmp_path / "jax", 4, True)
    params, state = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    want = jt.train(params, state, jt.optimizer.init(params))
    got = port.train()
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    for g, w in zip(got["val_metrics"], want["val_metrics"], strict=True):
        assert set(g) == set(w)
        for key, value in w.items():
            assert g[key] == pytest.approx(value, abs=1e-9), key
    assert port.chained_dispatches == jt.chained_dispatches > 0
    assert port.chained_eval_dispatches == jt.chained_eval_dispatches


@pytest.mark.parametrize("name", ["gat", "graph_transformer"])
def test_chained_run_of_the_other_models_equals_the_unchained_run_with_dropout(tmp_path, name):
    """GAT (attention and node dropout: 2 seeds a layer) and the standard
    Graph Transformer (4 seeds a layer, the FFN's two dropouts among them),
    lazy, dropout 0.1, chain 4 over two node buckets: losses, metrics and
    the whole state EQUAL to the unchained run's."""
    _, port_ds = _corpus(sessions=150, max_events=14)
    jax_model, params, state = _jax_model(name=name)
    runs = {}
    for chain in (1, 4):
        model = _port_model(jax_model, params, state, dropout=0.1)
        trainer = _port_trainer(port_ds, model, tmp_path / str(chain), chain, True)
        runs[chain] = (trainer, trainer.train())
    (plain, want), (chained, got) = runs[1], runs[4]
    assert chained.chained_dispatches > 0 and chained.chained_eval_dispatches > 0
    assert got == want
    for a, b in zip(_state_tensors(chained), _state_tensors(plain), strict=True):
        assert torch.equal(a, b)


def test_dense_trainer_takes_no_chain(corpus, tmp_path):
    _, port_ds = corpus
    jax_model, params, state = _jax_model()
    trainer = port_trainer.Trainer(
        _port_model(jax_model, params, state), lambda epoch: _port_batches(port_ds, epoch),
        lambda: _port_batches(port_ds), optimizer=FusedEmbeddingAdamW(**HP), output_dir=tmp_path,
        max_epochs=1, loss_fn=create_loss_function("dual"), chain=4, device="cpu")
    history = trainer.train()
    assert trainer.chain == 1 and np.isfinite(history["train_loss"][0])
    assert trainer.chained_dispatches == trainer.chained_eval_dispatches == 0
    assert trainer.opt_state["count"] == 10


def test_chain_groups_of_global_batch_items(corpus):
    """(batch, GlobalBatchMeta) items, as a mesh's data ranks get them, form
    the groups plain batches form (``transfer_chain_group``, which the
    Trainer and the bench share): a full group stacks the GradIndexes of the
    metas' global ids; a partial group runs as a SUBCHAIN and single steps
    (nine items at chain 12), each index from its meta; with several data
    ranks an item without global ids raises; a group that mixes such items
    with plain batches raises."""
    _, port_ds = corpus
    plain = list(_port_batches(port_ds))
    items = list(port_batching.iterate_batches(port_ds, BATCH, engine="numpy", with_global_ids=True))
    assert len(items) == len(plain) == 10 and all(isinstance(it, tuple) for it in items)
    group = port_trainer.transfer_chain_group

    def indexes(metas):
        return port_batching.stack_grad_indices([port_batching.make_grad_index_from_ids(m.ids) for m in metas])

    (entry,) = group(items[:4], 4, "cpu", n_data=2)
    assert entry[0] == "chained" and all(np.array_equal(g.numpy(), w)
                                         for g, w in zip(entry[2], indexes([m for _, m in items[:4]])))
    assert torch.equal(entry[1].node_ids, port_batching.stack_batches([b for b, _ in items[:4]]).node_ids)
    entries = group(items[:9], 12, "cpu", n_data=2)
    assert [isinstance(e[0], str) for e in entries] == [True, False]  # a SUBCHAIN, 1 single
    assert [isinstance(e[0], str) for e in group(plain[:9], 12, "cpu")] == [True, False]
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(entries[0][2], indexes([m for _, m in items[:8]])))
    single = port_batching.make_grad_index_from_ids(items[8][1].ids)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(entries[1][1], single))
    assert torch.equal(entries[1][0].node_ids, torch.as_tensor(items[8][0].node_ids))
    with pytest.raises(ValueError, match="global ids"):
        group(plain[:2], 4, "cpu", n_data=2)
    with pytest.raises(ValueError, match="mixes"):
        group([items[0], plain[1], items[2], plain[3]], 4, "cpu")


def test_a_resumed_chained_run_equals_an_uninterrupted_one(tmp_path):
    """Resume rebuilds the optimizer state and with it the chained step; the
    run goes on as if it had not stopped."""
    _, port_ds = _corpus(sessions=150, max_events=14)
    jax_model, params, state = _jax_model()

    def trainer(out, epochs):
        t = _port_trainer(port_ds, _port_model(jax_model, params, state), tmp_path / out, 4, True)
        t.max_epochs = epochs
        return t

    straight = trainer("straight", 3)
    want = straight.train()
    trainer("resumed", 2).train()
    resumed = trainer("resumed", 3)
    got = resumed.train(resume=True)
    assert got == want and resumed.chained_dispatches > 0
    for a, b in zip(_state_tensors(resumed), _state_tensors(straight), strict=True):
        assert torch.equal(a, b)
