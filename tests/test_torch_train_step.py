"""The port's training path vs the JAX package's, on the CPU at a small size.

Both packages start from the SAME mid-training state: the JAX model takes two
steps, then its params, BatchNorm state and optimizer state are carried over
by ``convert.from_jax_params`` and ``convert.opt_state_from_jax``. Five more
steps on the same batches (dropout 0, since the two packages draw different
random numbers) must agree: loss 1e-5 relative, moments atol 1e-6, weights
atol 1e-6 (see ``_assert_weights_close`` for the few entries AdamW's division
amplifies), BatchNorm buffers 1e-5 (float32 on both sides; matmul and
reduction orders differ between XLA and PyTorch).
Dropout is checked statistically and for its seeding. The Trainer's epoch
loss and recall/NDCG are held against the JAX Trainer's on a tiny corpus.
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
from gat_recommendation_torch.ops import masked as port_masked
from gat_recommendation_torch.train import trainer as port_trainer
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_tpu.data import batching as ref_batching
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.train import trainer as ref_trainer
from gat_recommendation_tpu.train.losses import create_loss_function as jax_create_loss
from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

torch.set_num_threads(1)

V, DIM = 300, 32
HP = dict(learning_rate=1e-3, weight_decay=1e-5)


def _corpus(seed=0, sessions=80):
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.geometric(0.25, sessions) + 2, 3, 30)
    total = int(lengths.sum())
    sid, ts = np.repeat(np.arange(sessions), lengths), np.arange(total)
    items = rng.integers(1, V, total)
    edges = (rng.integers(1, V, 12000), rng.integers(1, V, 12000))  # dense enough for real softmaxes
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": items})
    return (ref_batching.SessionDataset(df, edges, num_items=V),
            port_batching.SessionDataset((sid, ts, items), edges, num_items=V))


def _jax_model(dropout=0.0, seed=0):
    model = jax_create_model("graph_transformer_optimized", num_items=V, embedding_dim=DIM,
                             hidden_dim=DIM, laplacian_k=4, dropout=dropout)
    params, state = model.init_params(jax.random.key(seed))
    pe = np.random.default_rng(seed).normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    pe[V:] = 0.0
    state["cached_pe"] = jnp.asarray(pe)
    return model, params, state


def _port_model(jax_model, params, state, **overrides):
    cfg = {**dataclasses.asdict(jax_model.config), **overrides}
    model = registry.create_model(jax_model.name, cfg.pop("num_items"), device="cpu", **cfg)
    numpy_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    weights, buffers = convert.from_jax_params(
        numpy_tree(params), numpy_tree(state), dataclasses.asdict(jax_model.config))
    model.load_state_dict({**weights, **buffers})
    return model


def _assert_weights_close(got, want, name=""):
    """atol 1e-6 for all but at most 0.05 % of the entries, which stay within
    2e-5 (2 % of lr): where a gradient entry is itself at rounding-noise level,
    AdamW's m / (sqrt(v) + eps) turns its relative error into a share of lr."""
    err = np.abs(got - np.asarray(want))
    assert err.max() <= 2e-5, (name, err.max())
    assert np.mean(err > 1e-6) <= 5e-4, (name, np.mean(err > 1e-6))


def _compare(port_model, opt_state, params, state, jax_opt_state):
    _assert_weights_close(port_model.item_embedding.detach().numpy(), params["item_embedding"], "table")
    np.testing.assert_allclose(opt_state["emb_mu"].numpy(), np.asarray(jax_opt_state["emb_mu"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(opt_state["emb_nu"].numpy(), np.asarray(jax_opt_state["emb_nu"]), rtol=0, atol=1e-6)
    assert opt_state["count"] == int(jax_opt_state["count"])
    for layer, bn in enumerate(state["batch_norms"]):
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(port_model.batch_norms[layer], name).numpy(),
                                       np.asarray(bn[name]), rtol=1e-5, atol=1e-5, err_msg=name)
    for layer, conv in enumerate(params["convs"]):
        for name in ("query", "key", "value", "skip", "beta"):
            got = getattr(port_model.convs[layer], name).weight.detach().numpy()
            _assert_weights_close(got, np.asarray(conv[name]["w"]).T, name)
    _assert_weights_close(port_model.lap_projection.bias.detach().numpy(), params["lap_projection"]["b"])


def _trajectory(sparse: bool, steps=5, warm=2):
    jax_ds, port_ds = _corpus()
    jax_model, params, state = _jax_model()
    jax_opt = JaxOptimizer(**HP, use_pallas=False)
    jax_step = (ref_trainer.make_sparse_train_step if sparse else ref_trainer.make_train_step)(
        jax_model, jax_create_loss("dual"), jax_opt)
    opt_state = jax_opt.init(params)
    jax_batches = list(ref_batching.iterate_batches(jax_ds, 16, seed=1, engine="numpy"))
    port_batches = list(port_batching.iterate_batches(port_ds, 16, seed=1))
    assert len(jax_batches) >= warm + steps
    for i in range(warm):  # a mid-training state: nonzero moments, moved BatchNorm buffers
        params, state, opt_state, _ = jax_step(params, state, opt_state,
                                               ref_batching.to_device(jax_batches[i]), jax.random.key(i))

    model = _port_model(jax_model, params, state)
    port_opt = FusedEmbeddingAdamW(**HP)
    port_state = port_opt.load_state(
        port_opt.init(model), model,
        convert.opt_state_from_jax(jax.tree.map(np.asarray, opt_state), dataclasses.asdict(jax_model.config)))
    port_step = (port_trainer.make_sparse_train_step if sparse else port_trainer.make_train_step)(
        model, create_loss_function("dual"), port_opt, port_state)
    _compare(model, port_state, params, state, opt_state)
    start = model.convs[0].query.weight.detach().clone()
    losses = []
    for i in range(warm, warm + steps):
        params, state, opt_state, want = jax_step(params, state, opt_state,
                                                  ref_batching.to_device(jax_batches[i]), jax.random.key(i))
        got = port_step(port_batches[i], seed=i)
        assert got.item() == pytest.approx(float(want), rel=1e-5)
        losses.append(got.item())
        _compare(model, port_state, params, state, opt_state)
    assert (model.convs[0].query.weight.detach() - start).abs().max() > 1e-3  # it did train
    return model, port_state, losses


def test_sparse_train_step_reproduces_the_jax_trajectory():
    _trajectory(sparse=True)


def test_dense_train_step_reproduces_the_jax_trajectory():
    _trajectory(sparse=False)


def test_sparse_and_dense_steps_of_the_port_agree():
    sparse_model, sparse_state, sparse_losses = _trajectory(sparse=True)
    dense_model, dense_state, dense_losses = _trajectory(sparse=False)
    np.testing.assert_allclose(sparse_losses, dense_losses, rtol=1e-5)
    torch.testing.assert_close(sparse_model.item_embedding, dense_model.item_embedding, rtol=0, atol=1e-6)
    torch.testing.assert_close(sparse_state["emb_nu"], dense_state["emb_nu"], rtol=0, atol=1e-6)
    assert torch.all(sparse_model.item_embedding[0] == 0)  # the padding row never moves
    assert torch.all(sparse_state["emb_mu"][0] == 0) and torch.all(dense_state["emb_mu"][0] == 0)


def test_train_mode_forward_matches_jax_and_takes_gathered_rows():
    jax_ds, port_ds = _corpus(seed=2)
    jax_model, params, state = _jax_model(seed=2)
    model = _port_model(jax_model, params, state).train()
    a = next(ref_batching.iterate_batches(jax_ds, 16, engine="numpy"))
    b = next(port_batching.iterate_batches(port_ds, 16))
    want, new_state = jax_model.apply(params, state, ref_batching.to_device(a), jax_model.config, train=True)
    got = model(b)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for layer, bn in enumerate(new_state["batch_norms"]):
        np.testing.assert_allclose(model.batch_norms[layer].var.numpy(), np.asarray(bn["var"]), rtol=1e-5, atol=1e-5)
        assert model.batch_norms[layer].count.item() == float(bn["count"]) > 0
    rows = model.item_embedding.detach()[b.node_ids]
    model2 = _port_model(jax_model, params, state).train()
    torch.testing.assert_close(model2(b, node_embeddings=rows), got, rtol=1e-6, atol=1e-6)


def test_dropout_is_seeded_per_step_and_layer_and_off_in_eval():
    _, port_ds = _corpus(seed=3)
    jax_model, params, state = _jax_model(seed=3)
    model = _port_model(jax_model, params, state, dropout=0.3).train()
    batch = next(port_batching.iterate_batches(port_ds, 16))
    a, b, c = model(batch, seed=5), model(batch, seed=5), model(batch, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    # Eval ignores the seed and the rate (the running statistics moved above,
    # so the rate-0 twin takes them over first).
    model.eval()
    assert torch.equal(model(batch, seed=5), model(batch, seed=6))
    no_drop = _port_model(jax_model, params, state, dropout=0.0).eval()
    no_drop.load_state_dict(model.state_dict())
    torch.testing.assert_close(model(batch), no_drop(batch))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_node_dropout_keep_rate_and_scaling(rate):
    gen = torch.Generator().manual_seed(3)
    x = torch.ones(256, 256)
    y = port_masked.dropout(x, rate, True, gen)
    kept = y != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    assert abs(y.mean().item() - 1.0) < 0.02
    assert port_masked.dropout(x, rate, False, gen) is x and port_masked.dropout(x, 0.0, True, gen) is x


@pytest.mark.parametrize("sparse", [True, False])
def test_training_with_dropout_and_bf16_stochastic_moments_lowers_the_loss(sparse):
    _, port_ds = _corpus(seed=4)
    jax_model, params, state = _jax_model(seed=4)
    model = _port_model(jax_model, params, state, dropout=0.1)
    opt = FusedEmbeddingAdamW(1e-2, weight_decay=1e-5, moment_dtype=torch.bfloat16)
    assert opt.stochastic_rounding
    opt_state = opt.init(model)
    assert opt_state["emb_mu"].dtype == opt_state["emb_nu"].dtype == torch.bfloat16
    make = port_trainer.make_sparse_train_step if sparse else port_trainer.make_train_step
    step = make(model, create_loss_function("dual"), opt, opt_state)
    batch = next(port_batching.iterate_batches(port_ds, 16))
    losses = [step(batch, seed=i).item() for i in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert opt_state["count"] == 8 and opt_state["emb_nu"].float().abs().sum() > 0
    mixed = FusedEmbeddingAdamW(1e-3, moment_dtype=(torch.float32, torch.bfloat16))
    state2 = mixed.init(model)
    assert (state2["emb_mu"].dtype, state2["emb_nu"].dtype) == (torch.float32, torch.bfloat16)


def test_trainer_epoch_and_evaluate_match_the_jax_trainer(tmp_path):
    jax_ds, port_ds = _corpus(seed=5, sessions=120)
    jax_model, params, state = _jax_model(seed=5)
    loss = "dual"
    jt = ref_trainer.Trainer(
        jax_model,
        lambda epoch: ref_batching.iterate_batches(jax_ds, 16, shuffle=True, seed=epoch, engine="numpy"),
        lambda: ref_batching.iterate_batches(jax_ds, 16, engine="numpy"),
        optimizer=JaxOptimizer(**HP, use_pallas=False), output_dir=tmp_path,
        loss_fn=jax_create_loss(loss), sparse_embedding_grads=True)
    model = _port_model(jax_model, params, state)
    pt = port_trainer.Trainer(
        model,
        lambda epoch: port_batching.iterate_batches(port_ds, 16, shuffle=True, seed=epoch),
        lambda: port_batching.iterate_batches(port_ds, 16),
        optimizer=FusedEmbeddingAdamW(**HP), loss_fn=create_loss_function(loss),
        sparse_embedding_grads=True, device="cpu")
    pt.init_state(reset_parameters=False)
    opt_state = jt.optimizer.init(params)
    for epoch in range(2):
        jt.current_epoch = pt.current_epoch = epoch
        params, state, opt_state, want = jt.train_epoch(params, state, opt_state)
        got = pt.train_epoch()
        assert got == pytest.approx(want, rel=1e-5)
    want_metrics, got_metrics = jt.evaluate(params, state), pt.evaluate()
    assert set(got_metrics) == {"recall@10", "ndcg@10", "recall@20", "ndcg@20"} == set(want_metrics)
    for key, value in want_metrics.items():
        assert got_metrics[key] == pytest.approx(value, abs=1e-9), key
    assert pt.opt_state["count"] == int(opt_state["count"]) > 10
    assert pt.step_seed(0) != pt.step_seed(1)


def test_trainer_init_state_redraws_parameters_and_dense_default_optimizer():
    _, port_ds = _corpus(seed=6)
    model = registry.create_model("graph_transformer_optimized", V, embedding_dim=DIM, hidden_dim=DIM,
                                  laplacian_k=4, dropout=0.0, device="cpu")
    before = model.item_embedding.detach().clone()
    trainer = port_trainer.Trainer(
        model, lambda epoch: port_batching.iterate_batches(port_ds, 16, seed=epoch),
        lambda: port_batching.iterate_batches(port_ds, 16), seed=7, device="cpu")
    state = trainer.init_state()
    assert isinstance(trainer.optimizer, FusedEmbeddingAdamW) and trainer.optimizer.weight_decay == 1e-5
    assert not torch.equal(model.item_embedding, before) and state["count"] == 0
    first = trainer.train_epoch()
    assert np.isfinite(first) and state["count"] > 0
    empty = port_trainer.Trainer(model, lambda epoch: iter(()), lambda: iter(()), device="cpu")
    assert empty.train_epoch() == 0.0 and empty.evaluate()["recall@10"] == 0.0


def test_eval_step_matches_the_dense_oracle():
    _, port_ds = _corpus(seed=7)
    jax_model, params, state = _jax_model(seed=7)
    model = _port_model(jax_model, params, state)
    batch = next(port_batching.iterate_batches(port_ds, 16))
    two_level = port_trainer.make_eval_step(model, 20)(batch)
    dense = port_trainer.make_eval_step(model, 20, topk_method="dense")(batch)
    assert two_level.shape == (16, 20) and torch.equal(two_level, dense)
    assert not model.training


def test_factories_default_to_the_card_and_raise_without_one():
    kw = dict(embedding_dim=8, hidden_dim=8, laplacian_k=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.create_model("graph_transformer_optimized", 50, **kw)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_trainer.Trainer(registry.create_model("graph_transformer_optimized", 50, device="cpu", **kw),
                                 lambda epoch: iter(()), lambda: iter(()))
    on_cpu = registry.create_model("graph_transformer_optimized", 50, device="cpu", **kw)
    assert on_cpu.item_embedding.device.type == "cpu"
    on_meta = registry.create_model("graph_transformer_optimized", 50, device="meta", **kw)
    assert on_meta.item_embedding.device.type == "meta"


def test_unported_options_raise_naming_the_roadmap():
    model = registry.create_model("graph_transformer_optimized", 50, embedding_dim=8, hidden_dim=8,
                                  laplacian_k=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FusedEmbeddingAdamW(1e-3, lazy=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_trainer.Trainer(model, lambda epoch: iter(()), lambda: iter(()), chain=32, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.create_model("graph_transformer", 50, device="cpu")  # the FFN branch
    with pytest.raises(TypeError, match="update_sparse"):
        port_trainer.make_sparse_train_step(model, create_loss_function("bpr"), object(), {})
