"""The port's GAT (``models/layers.py::GATConv``, ``models/gat.py``) vs the JAX package's.

Weights come from the JAX ``init``, carried by ``convert.from_jax_params``;
the BatchNorm state and the conv biases are then perturbed with numpy so
that eval-mode BatchNorm is not the identity and the bias is not zero. The
same numpy inputs go through both. Tolerance 1e-5 (rtol and atol): float32
on both sides, matmul and reduction orders differ between XLA and PyTorch on
the CPU. Train mode is compared at dropout 0 (the two packages draw other
random bits); the attention dropout is checked for its seeding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch import convert
from gat_recommendation_torch.data.batching import SessionBatch
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.models.gat import layer_plan
from gat_recommendation_torch.models.layers import GATConv
from gat_recommendation_tpu.data.batching import SessionBatch as JaxSessionBatch
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.models import gat as jax_gat
from gat_recommendation_tpu.models.layers import gat_conv
from gat_recommendation_tpu.models.registry import count_params as jax_count_params

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
V, DIM = 100, 32


def _jax_model(seed=0, **kw):
    model = jax_create_model("gat", num_items=V, embedding_dim=DIM, hidden_dim=DIM, **kw)
    params, state = model.init_params(jax.random.key(seed))
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed)
    for conv in params["convs"]:
        conv["bias"] = rng.normal(0, 0.1, conv["bias"].shape).astype(np.float32)
    for bn_p, bn_s in zip(params["batch_norms"], state["batch_norms"]):
        bn_p["scale"] = rng.uniform(0.5, 1.5, bn_p["scale"].shape).astype(np.float32)
        bn_p["bias"] = rng.normal(0, 0.2, bn_p["bias"].shape).astype(np.float32)
        bn_s["mean"] = rng.normal(0, 0.3, bn_s["mean"].shape).astype(np.float32)
        bn_s["var"] = rng.uniform(0.5, 2.0, bn_s["var"].shape).astype(np.float32)
        bn_s["count"] = np.float32(1234.0)
    return model, params, state


def _port_model(model, params, state, **overrides):
    cfg = {**dataclasses.asdict(model.config), **overrides}
    port = registry.create_model(model.name, cfg.pop("num_items"), device="cpu", **cfg)
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(model.config), model.name)
    port.load_state_dict({**weights, **buffers})
    return port


def _batch(seed=0, B=3, N=8):
    rng = np.random.default_rng(seed)
    node_ids = np.zeros((B, N), np.int32)
    node_mask = np.zeros((B, N), bool)
    num_nodes = rng.integers(1, N + 1, B).astype(np.int32)
    num_nodes[0] = N
    for b, n in enumerate(num_nodes):
        node_ids[b, :n] = np.sort(rng.choice(np.arange(1, V), n, replace=False))
        node_mask[b, :n] = True
    adj = (rng.random((B, N, N)) < 0.4) & node_mask[:, :, None] & node_mask[:, None, :]
    adj[0, 1, :] = False  # a destination with no in-edge: only its self-loop
    return node_ids, node_mask, adj, num_nodes


def _both_batches(seed=0):
    arrays = _batch(seed)
    jax_batch = JaxSessionBatch(
        *(jnp.asarray(a) for a in arrays), targets=jnp.zeros((3,), jnp.int32),
        negatives=jnp.zeros((3, 1), jnp.int32), sample_mask=jnp.ones((3,), bool))
    return jax_batch, SessionBatch(*(torch.tensor(a) for a in arrays))


@pytest.mark.parametrize("concat", [False, True])
def test_gat_conv_layer_matches_jax(concat):
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, jax_gat.init_gat_conv(jax.random.key(1), DIM, 8, 4, concat))
    params["bias"] = rng.normal(0, 0.1, params["bias"].shape).astype(np.float32)
    x = rng.standard_normal((3, 8, DIM)).astype(np.float32)
    _, node_mask, adj, _ = _batch(2)
    want = gat_conv(params, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(node_mask), heads=4, concat=concat)

    layer = GATConv(DIM, 8, 4, concat, device="cpu")
    layer.load_state_dict({"lin.weight": torch.tensor(params["lin"]["w"]).T, "att_src": torch.tensor(params["att_src"]),
                           "att_dst": torch.tensor(params["att_dst"]), "bias": torch.tensor(params["bias"])})
    with torch.no_grad():
        got = layer(torch.tensor(x), torch.tensor(adj), torch.tensor(node_mask))
    assert got.shape == (3, 8, 32 if concat else 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(concat_heads=True, readout_type="attention"),
                                dict(num_layers=2, num_heads=2, readout_type="max")])
def test_forward_matches_jax(kw, train):
    """Eval mode with the perturbed running statistics; train mode at dropout
    0 with batch statistics, whose running buffers must move as JAX's do."""
    model, params, state = _jax_model(dropout=0.0, **kw)
    jax_batch, batch = _both_batches(3)
    want, new_state = jax_gat.apply(params, state, jax_batch, model.config, train=train)
    port = _port_model(model, params, state).train(train)
    with torch.no_grad():
        got = port(batch, seed=5)
    assert got.shape == (3, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for layer, bn in enumerate(new_state["batch_norms"]):
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(port.batch_norms[layer], name).numpy(), np.asarray(bn[name]), **TOL)


def test_layer_plan_and_parameter_count_match_jax():
    for kw in (dict(), dict(concat_heads=True), dict(num_layers=1), dict(num_layers=4, concat_heads=True)):
        model, params, state = _jax_model(**kw)
        assert layer_plan(registry.create_model("gat", V, device="meta", embedding_dim=DIM, hidden_dim=DIM,
                                                **kw).config) == jax_gat._layer_plan(model.config)
        port = _port_model(model, params, state)
        assert registry.count_params(port) == jax_count_params(params)
        assert len(port.convs) == len(params["convs"])


def test_convert_fills_every_tensor_and_the_moments():
    """Every parameter and buffer of the port's GAT comes from the JAX tree:
    ``lin`` transposed, ``att_*`` and ``bias`` as they are; the optimizer
    moments map to the same names."""
    from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

    model, params, state = _jax_model(concat_heads=True)
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(model.config), "gat")
    port = registry.create_model("gat", V, device="cpu", embedding_dim=DIM, hidden_dim=DIM, concat_heads=True)
    assert set(weights) | set(buffers) == set(port.state_dict())
    assert set(weights) == {k for k, _ in port.named_parameters()}
    np.testing.assert_array_equal(weights["convs.0.lin.weight"].numpy(), params["convs"][0]["lin"]["w"].T)
    np.testing.assert_array_equal(weights["convs.1.att_dst"].numpy(), params["convs"][1]["att_dst"])
    opt_state = jax.tree.map(np.asarray, JaxOptimizer(1e-3, use_pallas=False, lazy=True).init(params))
    carried = convert.opt_state_from_jax(opt_state, dataclasses.asdict(model.config), "gat")
    rest = {k for k in weights if k != "item_embedding"}
    assert {k.rsplit(".", 1)[0][len("rest."):] for k in carried if k.startswith("rest.")} == rest


def test_attention_dropout_is_seeded_per_step_and_layer():
    """Dropout on: the attention weights and the nodes are dropped by seeds
    from the step seed; one seed gives one result, another seed another, and
    eval mode ignores both."""
    model, params, state = _jax_model()
    port = _port_model(model, params, state, dropout=0.3).train()
    _, batch = _both_batches(4)
    a, b, c = port(batch, seed=5), port(batch, seed=5), port(batch, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    port.eval()
    assert torch.equal(port(batch, seed=5), port(batch, seed=6))
