"""The port's approx selector and two-level selector by chunk, against the JAX package's.

``approx_topk``: on the JAX CPU backend ``lax.approx_max_k`` returns the
exact top L, so the JAX selector's ids are the dense top-k; the port's are
exact on every device. Ids must be EQUAL at [4, 100,000], L = 128, k = 20,
and around it (a phantom tail, L below k, L >= V, V off the chunk).

``two_level_topk(chunk=)``: chunk 32 runs kernel 2's wrapper (its plain
version here), other chunks the plain selection in PyTorch; ids must equal
the JAX function's for chunks 8, 16, 32 and 64, ties included (the
integer-valued cases), and the JAX package's dense fallbacks must hold.
Scores within 1e-5 (float32, summation order differs).

``make_eval_step(topk_method="approx")``: the eval step's ids equal the JAX
eval step's on the same converted model and batch.
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
from gat_recommendation_torch.ops import scoring as port_scoring
from gat_recommendation_torch.train import trainer as port_trainer
from gat_recommendation_tpu.data import batching as ref_batching
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.ops import scoring as jax_scoring
from gat_recommendation_tpu.train import trainer as ref_trainer

torch.set_num_threads(1)


def _normal(seed, B, V, D):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, D)).astype(np.float32), rng.standard_normal((V, D)).astype(np.float32)


def _integer(seed, B, V, D):
    """Entries in {-1, 0, 1}: small exact integer scores that tie massively."""
    rng = np.random.default_rng(seed)
    return rng.integers(-1, 2, (B, D)).astype(np.float32), rng.integers(-1, 2, (V, D)).astype(np.float32)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("V,num_items,k,candidates", [
    (100_000, None, 20, 128),  # the case the JAX CPU backend was checked at
    (100_000, 99_900, 20, 128),  # a phantom tail
    (100_000, None, 200, 128),  # L = k
    (100_001, None, 20, 256),  # V off the chunk: kernel 2 on the padded table
    (96, None, 10, 128),  # L >= V: the dense top-k
])
def test_approx_topk_ids_equal_jax(V, num_items, k, candidates):
    sess, table = _normal(V + k, 4, V, 16)
    want = jax_scoring.approx_topk(jnp.asarray(sess), jnp.asarray(table), k, num_items, candidates=candidates)
    got = port_scoring.approx_topk(torch.from_numpy(sess), torch.from_numpy(table), k, num_items,
                                   candidates=candidates)
    _assert_same(got, want)
    dense = jax_scoring.dense_topk(jnp.asarray(sess), jnp.asarray(table), k, num_items)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(dense[1]))
    via = port_scoring.full_catalog_topk(torch.from_numpy(sess), torch.from_numpy(table), k, num_items,
                                         method="approx", candidates=candidates)
    assert torch.equal(via[1], got[1])


def test_approx_topk_is_exact_with_ties_and_an_exclusion_mask():
    sess, table = _integer(3, 3, 32_768, 16)
    exclude = torch.from_numpy(np.random.default_rng(3).random((3, 32_768)) < 0.01)
    got = port_scoring.approx_topk(torch.from_numpy(sess), torch.from_numpy(table), 20, 32_000, exclude=exclude)
    want = port_scoring.dense_topk(torch.from_numpy(sess), torch.from_numpy(table), 20, 32_000, exclude)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    want_jax = jax_scoring.dense_topk(jnp.asarray(sess), jnp.asarray(table), 20, 32_000)
    plain = port_scoring.approx_topk(torch.from_numpy(sess), torch.from_numpy(table), 20, 32_000)
    np.testing.assert_array_equal(plain[1].numpy(), np.asarray(want_jax[1]))


@pytest.mark.parametrize("B", [1, 3])
def test_a_table_off_the_chunk_goes_through_the_kernels_wrapper_padded(B, monkeypatch):
    """V % 32 != 0 at chunk 32: kernel 2 runs on a zero-padded copy (a [V]
    mask at B = 1, [B, V] above), and the ids equal the dense top-k's."""
    V = 32_750
    sess, table = (torch.from_numpy(a) for a in _integer(B, B, V, 16))
    exclude = torch.from_numpy(np.random.default_rng(B).random((B, V)) < 0.01)
    exclude = exclude[0] if B == 1 else exclude
    rows = []
    real = port_scoring.score_chunkmax
    monkeypatch.setattr(port_scoring, "score_chunkmax", lambda s, t, *a: rows.append(t.shape[0]) or real(s, t, *a))
    want = port_scoring.dense_topk(sess, table, 20, 32_700, exclude)
    for got in (port_scoring.two_level_topk(sess, table, 20, 32_700, exclude=exclude),
                port_scoring.approx_topk(sess, table, 20, 32_700, exclude=exclude)):
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert rows == [32_768, 32_768]


@pytest.mark.parametrize("make", [_normal, _integer])
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
@pytest.mark.parametrize("num_items", [None, 65_000])
def test_two_level_topk_by_chunk_ids_equal_jax(make, chunk, num_items):
    sess, table = make(chunk, 4, 65_536, 16)
    want = jax_scoring.two_level_topk(jnp.asarray(sess), jnp.asarray(table), 20, num_items, chunk=chunk)
    got = port_scoring.two_level_topk(torch.from_numpy(sess), torch.from_numpy(table), 20, num_items, chunk=chunk)
    _assert_same(got, want)
    via = port_scoring.full_catalog_topk(torch.from_numpy(sess), torch.from_numpy(table), 20, num_items,
                                         method="two_level", chunk=chunk)
    assert torch.equal(via[1], got[1])


def test_chunk_32_goes_through_the_kernels_wrapper_and_other_chunks_do_not(monkeypatch):
    sess, table = (torch.from_numpy(a) for a in _normal(1, 2, 32_768, 8))
    calls = []
    real = port_scoring.score_chunkmax
    monkeypatch.setattr(port_scoring, "score_chunkmax", lambda *a: calls.append(1) or real(*a))
    port_scoring.two_level_topk(sess, table, 10)
    port_scoring.approx_topk(sess, table, 10)
    assert len(calls) == 2
    for chunk in (8, 16, 64):
        port_scoring.two_level_topk(sess, table, 10, chunk=chunk)
    assert len(calls) == 2


@pytest.mark.parametrize("V,chunk,k", [
    (8_192, 16, 20),  # V below MIN_ROWS_FOR_TWO_LEVEL
    (16_416, 64, 20),  # V not a multiple of the chunk
    (16_384, 64, 300),  # fewer chunks than k
    (16_400, 32, 20),  # chunk 32, V not a multiple of 32: no fallback, kernel 2 on the padded table
])
def test_dense_fallbacks_hold(V, chunk, k, monkeypatch):
    sess, table = _integer(V, 3, V, 16)
    monkeypatch.setattr(port_scoring, "two_level_topk_scores", None)  # the fallbacks sort the whole row
    rows = []
    if chunk == port_scoring.DEFAULT_CHUNK:
        real = port_scoring.score_chunkmax
        monkeypatch.setattr(port_scoring, "score_chunkmax", lambda s, t, *a: rows.append(t.shape[0]) or real(s, t, *a))
    else:
        monkeypatch.setattr(port_scoring, "score_chunkmax", None)
    got = port_scoring.two_level_topk(torch.from_numpy(sess), torch.from_numpy(table), k, chunk=chunk)
    assert rows == ([V + (-V) % 32] if chunk == port_scoring.DEFAULT_CHUNK else [])
    want = jax_scoring.two_level_topk(jnp.asarray(sess), jnp.asarray(table), k, chunk=chunk)
    _assert_same(got, want)
    dense = jax.lax.top_k(jnp.asarray(sess) @ jnp.asarray(table).T, k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(dense[1]))


NUM_ITEMS, DIM = 2_000, 16


def _datasets(seed=0, sessions=64):
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.geometric(0.25, sessions) + 2, 3, 30)
    sid, ts = np.repeat(np.arange(sessions), lengths), np.arange(int(lengths.sum()))
    items = rng.integers(1, NUM_ITEMS, int(lengths.sum()))
    edges = (rng.integers(1, NUM_ITEMS, 20_000), rng.integers(1, NUM_ITEMS, 20_000))
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": items})
    return (ref_batching.SessionDataset(df, edges, num_items=NUM_ITEMS),
            port_batching.SessionDataset((sid, ts, items), edges, num_items=NUM_ITEMS))


def test_eval_step_with_approx_matches_the_jax_eval_step():
    jax_ds, port_ds = _datasets()
    model = jax_create_model("graph_transformer_optimized", num_items=NUM_ITEMS, embedding_dim=DIM,
                             hidden_dim=DIM, laplacian_k=4, dropout=0.0)
    params, state = model.init_params(jax.random.key(0))
    state = jax.tree.map(np.asarray, state)
    state["cached_pe"] = np.random.default_rng(0).normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    weights, buffers = convert.from_jax_params(jax.tree.map(np.asarray, params), state,
                                               dataclasses.asdict(model.config))
    cfg = dataclasses.asdict(model.config)
    port_model = registry.create_model(model.name, cfg.pop("num_items"), device="cpu", **cfg)
    port_model.load_state_dict({**weights, **buffers})

    jax_step = ref_trainer.make_eval_step(model, 20, topk_method="approx")
    port_step = port_trainer.make_eval_step(port_model, 20, topk_method="approx")
    exact = port_trainer.make_eval_step(port_model, 20)
    for want_batch, got_batch in zip(ref_batching.iterate_batches(jax_ds, 16, engine="numpy"),
                                     port_batching.iterate_batches(port_ds, 16, engine="numpy")):
        want = np.asarray(jax_step(params, state, want_batch))
        got = port_step(got_batch)
        assert got.shape == (16, 20)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, exact(got_batch))
