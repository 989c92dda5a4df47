"""The port's GraphSAGE (``models/layers.py::SAGEConv``, ``LSTMAggregator``,
``models/graphsage.py``) vs the JAX package's, for the mean, max and LSTM
aggregators.

Weights come from the JAX ``init``, carried by ``convert.from_jax_params``
(the LSTM's ``w_ih``/``w_hh`` transposed into ``torch.nn.LSTMCell``'s
layout); the BatchNorm state is perturbed with numpy. The same numpy inputs
go through both. Tolerance 1e-5 (rtol and atol) for every aggregator, the
LSTM included: its largest error here is 1.1e-6, in the train-mode forward
with the attention readout (float32; matmul and reduction orders differ
between XLA and PyTorch on the CPU). Train mode is compared at dropout 0.
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
from gat_recommendation_torch.models.layers import LSTMAggregator, SAGEConv
from gat_recommendation_tpu.data.batching import SessionBatch as JaxSessionBatch
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.models import graphsage as jax_graphsage
from gat_recommendation_tpu.models.layers import init_sage_conv, sage_conv
from gat_recommendation_tpu.models.registry import count_params as jax_count_params

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
V, DIM = 100, 32
AGGREGATORS = ["mean", "max", "lstm"]


def _jax_model(aggregator, seed=0, **kw):
    model = jax_create_model("graphsage", num_items=V, embedding_dim=DIM, hidden_dim=DIM,
                             aggregator=aggregator, **kw)
    params, state = model.init_params(jax.random.key(seed))
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed)
    for bn_p, bn_s in zip(params["batch_norms"], state["batch_norms"]):
        bn_p["scale"] = rng.uniform(0.5, 1.5, bn_p["scale"].shape).astype(np.float32)
        bn_p["bias"] = rng.normal(0, 0.2, bn_p["bias"].shape).astype(np.float32)
        bn_s["mean"] = rng.normal(0, 0.3, bn_s["mean"].shape).astype(np.float32)
        bn_s["var"] = rng.uniform(0.5, 2.0, bn_s["var"].shape).astype(np.float32)
        bn_s["count"] = np.float32(1234.0)
    return model, params, state


def _port_model(model, params, state):
    cfg = dataclasses.asdict(model.config)
    port = registry.create_model(model.name, cfg.pop("num_items"), device="cpu", **cfg)
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(model.config), model.name)
    port.load_state_dict({**weights, **buffers})
    return port


def _arrays(seed=0, B=3, N=8):
    rng = np.random.default_rng(seed)
    node_ids = np.zeros((B, N), np.int32)
    node_mask = np.zeros((B, N), bool)
    num_nodes = rng.integers(1, N + 1, B).astype(np.int32)
    num_nodes[0] = N
    for b, n in enumerate(num_nodes):
        node_ids[b, :n] = np.sort(rng.choice(np.arange(1, V), n, replace=False))
        node_mask[b, :n] = True
    adj = (rng.random((B, N, N)) < 0.4) & node_mask[:, :, None] & node_mask[:, None, :]
    adj[0, 2, :] = False  # a destination without neighbours aggregates to zero
    return node_ids, node_mask, adj, num_nodes


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_conv_layer_matches_jax(aggregator):
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, init_sage_conv(jax.random.key(1), DIM, 16, aggregator))
    x = rng.standard_normal((3, 8, DIM)).astype(np.float32)
    _, _, adj, _ = _arrays(2)
    want = sage_conv(params, jnp.asarray(x), jnp.asarray(adj), aggregator=aggregator)

    layer = SAGEConv(DIM, 16, aggregator, device="cpu")
    state = {"lin_l.weight": torch.tensor(params["lin_l"]["w"]).T, "lin_l.bias": torch.tensor(params["lin_l"]["b"]),
             "lin_r.weight": torch.tensor(params["lin_r"]["w"]).T}
    if aggregator == "lstm":
        lstm = params["lstm"]
        state.update({"lstm.weight_ih": torch.tensor(lstm["w_ih"]).T, "lstm.weight_hh": torch.tensor(lstm["w_hh"]).T,
                      "lstm.bias_ih": torch.tensor(lstm["b_ih"]), "lstm.bias_hh": torch.tensor(lstm["b_hh"])})
    layer.load_state_dict(state)
    with torch.no_grad():
        got = layer(torch.tensor(x), torch.tensor(adj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_forward_matches_jax(aggregator, train):
    model, params, state = _jax_model(aggregator, dropout=0.0, readout_type="attention" if train else "mean")
    arrays = _arrays(3)
    jax_batch = JaxSessionBatch(
        *(jnp.asarray(a) for a in arrays), targets=jnp.zeros((3,), jnp.int32),
        negatives=jnp.zeros((3, 1), jnp.int32), sample_mask=jnp.ones((3,), bool))
    want, new_state = jax_graphsage.apply(params, state, jax_batch, model.config, train=train)
    port = _port_model(model, params, state).train(train)
    with torch.no_grad():
        got = port(SessionBatch(*(torch.tensor(a) for a in arrays)), seed=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for layer, bn in enumerate(new_state["batch_norms"]):
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(port.batch_norms[layer], name).numpy(), np.asarray(bn[name]), **TOL)


def test_lstm_steps_over_neighbours_only():
    """A source slot that is not a neighbour leaves the state as it was: a
    destination whose only neighbour is source j gets one LSTM step of x_j
    from the zero state, whatever lies around j; no neighbour gives zero."""
    torch.manual_seed(0)
    agg = LSTMAggregator(6, device="cpu")
    agg.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn(1, 5, 6)
    adj = torch.zeros(1, 5, 5, dtype=torch.bool)
    adj[0, 0, 3] = True
    with torch.no_grad():
        h = agg(x, adj)
        cell = torch.nn.LSTMCell(6, 6)
        cell.load_state_dict({k: getattr(agg, k) for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")})
        want, _ = cell(x[0, 3:4])
    torch.testing.assert_close(h[0, 0:1], want, rtol=1e-6, atol=1e-6)
    assert torch.all(h[0, 1:] == 0)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_convert_and_parameter_count_cover_every_tensor(aggregator):
    from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

    model, params, state = _jax_model(aggregator, num_layers=2)
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(model.config), "graphsage")
    port = _port_model(model, params, state)
    assert set(weights) | set(buffers) == set(port.state_dict())
    assert registry.count_params(port) == jax_count_params(params)
    opt_state = jax.tree.map(np.asarray, JaxOptimizer(1e-3, use_pallas=False).init(params))
    carried = convert.opt_state_from_jax(opt_state, dataclasses.asdict(model.config), "graphsage")
    assert {k.rsplit(".", 1)[0][len("rest."):] for k in carried if k.startswith("rest.")} == set(weights) - {"item_embedding"}
    with pytest.raises(ValueError, match="aggregator"):
        registry.create_model("graphsage", V, device="cpu", aggregator="sum")
