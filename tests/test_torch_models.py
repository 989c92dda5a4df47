"""The port's model code vs the JAX package, with weights carried by convert.py.

Weights come from the JAX ``init``; the BatchNorm state and ``cached_pe`` are
then perturbed with numpy so that eval-mode BatchNorm is not the identity.
Tolerance 1e-5 (rtol and atol): float32 on both sides, matmul and reduction
orders differ between XLA and PyTorch on the CPU.
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
from gat_recommendation_torch.models.layers import TransformerConv
from gat_recommendation_torch.ops import masked as port_masked
from gat_recommendation_tpu.data.batching import SessionBatch as JaxSessionBatch
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.models.layers import transformer_conv
from gat_recommendation_tpu.ops import masked as jax_masked

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _perturbed_jax_model(readout="mean", num_layers=2, seed=0):
    model = jax_create_model(
        "graph_transformer_optimized",
        num_items=100,
        embedding_dim=32,
        hidden_dim=32,
        num_layers=num_layers,
        laplacian_k=4,
        readout_type=readout,
    )
    params, state = model.init_params(jax.random.key(seed))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed)
    for bn_p, bn_s in zip(params["batch_norms"], state["batch_norms"]):
        bn_p["scale"] = rng.uniform(0.5, 1.5, bn_p["scale"].shape).astype(np.float32)
        bn_p["bias"] = rng.normal(0, 0.2, bn_p["bias"].shape).astype(np.float32)
        bn_s["mean"] = rng.normal(0, 0.3, bn_s["mean"].shape).astype(np.float32)
        bn_s["var"] = rng.uniform(0.5, 2.0, bn_s["var"].shape).astype(np.float32)
        bn_s["count"] = np.float32(1234.0)
    state["cached_pe"] = rng.normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    state["cached_pe"][100:] = 0.0
    return model, params, state


def _batch(seed=0, B=3, N=8):
    rng = np.random.default_rng(seed)
    node_ids = np.zeros((B, N), np.int32)
    node_mask = np.zeros((B, N), bool)
    num_nodes = rng.integers(1, N + 1, B).astype(np.int32)
    num_nodes[0] = N
    for b, n in enumerate(num_nodes):
        node_ids[b, :n] = np.sort(rng.choice(np.arange(1, 100), n, replace=False))
        node_mask[b, :n] = True
    adj = (rng.random((B, N, N)) < 0.4) & node_mask[:, :, None] & node_mask[:, None, :]
    return node_ids, node_mask, adj, num_nodes


def _port_model(jax_model, params, state):
    cfg = dataclasses.asdict(jax_model.config)
    num_items = cfg.pop("num_items")
    model = registry.create_model(jax_model.name, num_items, device="cpu", **cfg)
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(jax_model.config), jax_model.name)
    model.load_state_dict({**weights, **buffers})
    return model.eval()


def test_transformer_conv_layer_matches_jax():
    model, params, state = _perturbed_jax_model()
    node_ids, node_mask, adj, _ = _batch(1)
    x = np.random.default_rng(2).standard_normal((3, 8, 32)).astype(np.float32)
    want = transformer_conv(params["convs"][0], jnp.asarray(x), jnp.asarray(adj), heads=2)

    weights, _ = convert.from_jax_params(params, state, dataclasses.asdict(model.config))
    layer = TransformerConv(32, 16, 2)
    layer.load_state_dict({k[len("convs.0."):]: v for k, v in weights.items() if k.startswith("convs.0.")})
    with torch.no_grad():
        got = layer(torch.tensor(x), torch.tensor(adj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "readout,num_layers", [("mean", 2), ("max", 2), ("last", 1), ("attention", 3)]
)
def test_eval_forward_matches_jax(readout, num_layers):
    from gat_recommendation_tpu.models import graph_transformer as jax_gt

    model, params, state = _perturbed_jax_model(readout, num_layers)
    node_ids, node_mask, adj, num_nodes = _batch(3)
    jax_batch = JaxSessionBatch(
        node_ids=jnp.asarray(node_ids),
        node_mask=jnp.asarray(node_mask),
        adj=jnp.asarray(adj),
        num_nodes=jnp.asarray(num_nodes),
        targets=jnp.zeros((3,), jnp.int32),
        negatives=jnp.zeros((3, 1), jnp.int32),
        sample_mask=jnp.ones((3,), bool),
    )
    want, _ = jax_gt.apply(params, state, jax_batch, model.config, train=False)

    port = _port_model(model, params, state)
    batch = SessionBatch(*(torch.tensor(a) for a in (node_ids, node_mask, adj, num_nodes)))
    with torch.no_grad():
        got = port(batch)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_train_mode_forward_and_ffn_are_not_ported():
    """Once the refusal of the FFN, GAT and GraphSAGE; since they were ported
    every model name builds on the CPU and its train-mode forward runs (batch
    statistics, seeded dropout). An unknown name still raises."""
    small = dict(embedding_dim=8, hidden_dim=8, device="cpu")
    batch = SessionBatch(*(torch.tensor(a) for a in _batch(0, 1, 8)))
    for name in registry.MODEL_NAMES:
        extra = dict(laplacian_k=2) if name.startswith("graph_transformer") else {}
        model = registry.create_model(name, 50, **small, **extra)
        assert model.training and model.name == name
        out = model(batch, seed=1)
        assert out.shape == (1, 8) and torch.isfinite(out).all() and model.batch_norms[0].count > 0
    assert registry.create_model("graph_transformer", 50, laplacian_k=2, **small).ffns is not None
    with pytest.raises(ValueError):
        registry.create_model("nope", 50)


def test_init_pads_the_table_and_follows_the_generator():
    kw = dict(embedding_dim=8, hidden_dim=8, laplacian_k=2)
    a = registry.create_model("graph_transformer_optimized", 700, generator=torch.Generator().manual_seed(5), device="cpu", **kw)
    b = registry.create_model("graph_transformer_optimized", 700, generator=torch.Generator().manual_seed(5), device="cpu", **kw)
    table = a.item_embedding.detach()
    assert table.shape == (1024, 8)
    assert torch.all(table[0] == 0) and torch.all(table[700:] == 0)
    bound = np.sqrt(6.0 / (699 + 8))
    assert 0 < table[1:700].abs().max() <= bound
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize("train", [False, True])
def test_masked_batch_norm_matches_jax(train):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 8, 6)).astype(np.float32)
    mask = rng.random((3, 8)) < 0.6
    p = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32), "bias": rng.normal(size=6).astype(np.float32)}
    s = {"mean": rng.normal(size=6).astype(np.float32), "var": rng.uniform(0.5, 2, 6).astype(np.float32),
         "count": np.float32(3.0)}
    want, want_s = jax_masked.masked_batch_norm(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s), jnp.asarray(x), jnp.asarray(mask), train
    )
    buf = {k: torch.tensor(v) for k, v in s.items()}
    got = port_masked.masked_batch_norm(
        torch.tensor(p["scale"]), torch.tensor(p["bias"]), buf["mean"], buf["var"], buf["count"],
        torch.tensor(x), torch.tensor(mask), train,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(buf[k].numpy(), np.asarray(want_s[k]), **TOL)


def test_masked_reductions_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 8, 5)).astype(np.float32)
    mask = rng.random((4, 8)) < 0.5
    mask[1] = False  # an empty row: every reduction gives exact zeros
    for name in ("masked_mean", "masked_max"):
        want = getattr(jax_masked, name)(jnp.asarray(x), jnp.asarray(mask), axis=1)
        got = getattr(port_masked, name)(torch.tensor(x), torch.tensor(mask), dim=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert np.all(got.numpy()[1] == 0.0)
    scores = rng.standard_normal((4, 8)).astype(np.float32)
    want = jax_masked.masked_softmax(jnp.asarray(scores), jnp.asarray(mask), axis=-1)
    got = port_masked.masked_softmax(torch.tensor(scores), torch.tensor(mask), dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[1] == 0.0)


def test_dropout_scales_kept_entries_and_is_identity_in_eval():
    """RNG streams differ between the frameworks, so dropout is checked in
    distribution: the kept share and the 1/(1-rate) scale."""
    x = torch.ones(200_000)
    assert port_masked.dropout(x, 0.25, train=False) is x
    out = port_masked.dropout(x, 0.25, train=True, seed=0)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))


@pytest.mark.parametrize("num_items", [None, 40, 64])
def test_mask_phantom_matches_jax(num_items):
    from gat_recommendation_torch.models.base import mask_phantom
    from gat_recommendation_tpu.models.base import mask_phantom as jax_mask_phantom

    scores = np.random.default_rng(9).standard_normal((2, 64)).astype(np.float32)
    want = jax_mask_phantom(jnp.asarray(scores), num_items)
    got = mask_phantom(torch.tensor(scores), num_items)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ffn_layer_matches_jax():
    """The FFN branch as the JAX Graph Transformer applies it
    (``models/graph_transformer.py``: up, exact GELU, down, residual) at dropout 0."""
    from gat_recommendation_torch.models.layers import FeedForward
    from gat_recommendation_tpu.models.base import linear, torch_linear_init

    ku, kd = jax.random.split(jax.random.key(4))
    up, down = (jax.tree.map(np.asarray, p) for p in (torch_linear_init(ku, 32, 128), torch_linear_init(kd, 128, 32)))
    x = np.random.default_rng(4).standard_normal((3, 8, 32)).astype(np.float32)
    want = linear(down, jax.nn.gelu(linear(up, jnp.asarray(x)), approximate=False)) + x
    layer = FeedForward(32, 4, device="cpu")
    layer.load_state_dict({"up.weight": torch.tensor(up["w"]).T, "up.bias": torch.tensor(up["b"]),
                           "down.weight": torch.tensor(down["w"]).T, "down.bias": torch.tensor(down["b"])})
    with torch.no_grad():
        got = layer(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("readout", ["mean", "attention"])
def test_graph_transformer_with_ffn_matches_jax(readout, train):
    """The standard Graph Transformer (3 layers, 4 heads, the FFN, PE) in eval
    mode and in train mode at dropout 0, its running statistics moved alike."""
    from gat_recommendation_tpu.models import graph_transformer as jax_gt

    model = jax_create_model("graph_transformer", num_items=100, embedding_dim=32, hidden_dim=32,
                             laplacian_k=4, readout_type=readout, dropout=0.0)
    params, state = model.init_params(jax.random.key(6))
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(6)
    for bn_s in state["batch_norms"]:
        bn_s["mean"] = rng.normal(0, 0.3, bn_s["mean"].shape).astype(np.float32)
        bn_s["var"] = rng.uniform(0.5, 2.0, bn_s["var"].shape).astype(np.float32)
    state["cached_pe"] = rng.normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    node_ids, node_mask, adj, num_nodes = _batch(7)
    jax_batch = JaxSessionBatch(
        node_ids=jnp.asarray(node_ids), node_mask=jnp.asarray(node_mask), adj=jnp.asarray(adj),
        num_nodes=jnp.asarray(num_nodes), targets=jnp.zeros((3,), jnp.int32),
        negatives=jnp.zeros((3, 1), jnp.int32), sample_mask=jnp.ones((3,), bool))
    want, new_state = jax_gt.apply(params, state, jax_batch, model.config, train=train)

    port = _port_model(model, params, state).train(train)
    assert port.seeds_per_layer == 4 and len(port.ffns) == 3
    with torch.no_grad():
        got = port(SessionBatch(*(torch.tensor(a) for a in (node_ids, node_mask, adj, num_nodes))), seed=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for layer, bn in enumerate(new_state["batch_norms"]):
        np.testing.assert_allclose(port.batch_norms[layer].var.numpy(), np.asarray(bn["var"]), **TOL)


@pytest.mark.parametrize("name,kw", [
    ("graph_transformer", {"laplacian_k": 4}),
    ("graph_transformer_optimized", {"laplacian_k": 4, "readout_type": "attention"}),
    ("gat", {"concat_heads": True}),
    ("graphsage", {"aggregator": "max"}),
    ("graphsage", {"aggregator": "lstm", "readout_type": "attention"}),
])
def test_convert_fills_every_model_and_counts_its_parameters(name, kw):
    """``convert.from_jax_params`` under the JAX model's name gives every
    parameter and buffer of the port's model, shaped as the port's; the
    registry counts as many parameters as the JAX package's."""
    from gat_recommendation_tpu.models.registry import count_params as jax_count_params

    model = jax_create_model(name, num_items=100, embedding_dim=16, hidden_dim=16, **kw)
    params, state = (jax.tree.map(np.asarray, t) for t in model.init_params(jax.random.key(0)))
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(model.config), model.name)
    port = _port_model(model, params, state)
    want = port.state_dict()
    assert set(weights) | set(buffers) == set(want) and not set(weights) & set(buffers)
    assert all(t.shape == want[k].shape for k, t in {**weights, **buffers}.items())
    assert registry.count_params(port) == jax_count_params(params)
