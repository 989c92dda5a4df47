"""The port's int8 serving path against the JAX package's, on the CPU.

One JAX checkpoint (initialised, BatchNorm statistics and PE perturbed) is
served by the JAX ``Recommender(int8_scoring=True)``; the same weights,
carried across by ``convert.from_jax_params``, by the port's
``Recommender(int8_scoring=True, device="cpu")``. Both quantize the table
with their own copy of the C++ scorer, scan for L = max(1024, 8k) candidates
and re-rank them in float32. Item ids must be EQUAL and scores within 1e-5
(float32, the forward's summation order differs), over requests in every
node bucket. The table has 3,072 rows, so the 1,024 candidates are a third
of it. "auto" must choose the int8 path on the CPU from 100,000 rows and
not below, and ``health()`` must say which path runs.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from gat_recommendation_torch import convert
from gat_recommendation_torch.data import native as port_native
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.serving import latency_bench
from gat_recommendation_torch.serving import recommender as port_rec
from gat_recommendation_torch.serving.validation import ValidatedRequest as PortRequest
from gat_recommendation_torch.train import checkpoint as port_ckpt
from gat_recommendation_tpu.data import native as ref_native
from gat_recommendation_tpu.serving.validation import ValidatedRequest as JaxRequest

torch.set_num_threads(1)

NUM_ITEMS = 3000  # 3,072 rows
BUCKETS = (8, 16, 32, 56)
SMALL = dict(embedding_dim=16, hidden_dim=16, laplacian_k=4)


@pytest.fixture(scope="module")
def jax_library():
    """The JAX package's library, retried while another test process's first
    ``make -C native`` is still writing it."""
    for _ in range(120):
        if ref_native.available():
            return ref_native
        ref_native._load_attempted = False
        time.sleep(1.0)
    pytest.fail("the JAX package's C++ library did not build (make -C native)")


def _edges(rng, num_items, path):
    item_i = rng.integers(1, num_items - 40, 6 * num_items)
    item_j = item_i + rng.integers(1, 40, item_i.shape)
    item_j[:50] = item_i[:50]  # self-loops, dropped by both recommenders
    np.savez(path, item_i=item_i, item_j=item_j)
    return path


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, jax_library):
    from gat_recommendation_tpu.models import create_model
    from gat_recommendation_tpu.train import checkpoint as jax_ckpt

    out = tmp_path_factory.mktemp("int8")
    model = create_model("graph_transformer_optimized", num_items=NUM_ITEMS, **SMALL)
    params, state = model.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    state = jax.tree.map(np.asarray, state)
    for bn in state["batch_norms"]:
        bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    state["cached_pe"] = rng.normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    meta = {"epoch": 2, "best_val_metric": 0.5, "model_name": model.name,
            "model_config": dataclasses.asdict(model.config)}
    jax_ckpt.save(out / "jax_ckpt", params, state, {"dummy": np.zeros(1)}, meta)

    weights, buffers = convert.from_jax_params(jax.tree.map(np.asarray, params), state, meta["model_config"])
    cfg = dict(meta["model_config"])
    port_model = registry.create_model(model.name, cfg.pop("num_items"), device="cpu", **cfg)
    port_model.load_state_dict({**weights, **buffers})
    port_ckpt.save(out / "port_ckpt", port_model, epoch=2, best_val_metric=0.5)
    return out / "jax_ckpt", out / "port_ckpt", _edges(rng, NUM_ITEMS, out / "edges.npz")


@pytest.fixture(scope="module")
def recommenders(checkpoints):
    from gat_recommendation_tpu.serving.recommender import Recommender as JaxRecommender

    jax_path, port_path, edges = checkpoints
    jax_r = JaxRecommender(jax_path, edges, buckets=BUCKETS, warmup=False, int8_scoring=True)
    port_r = port_rec.Recommender(port_path, edges, buckets=BUCKETS, warmup=False, device="cpu",
                                  int8_scoring=True)
    assert jax_r.int8_scoring and port_r.int8_scoring
    return jax_r, port_r


def _sessions():
    rng = np.random.default_rng(5)
    out = []
    for n_unique, k in ((3, 10), (6, 20), (12, 10), (25, 150), (40, 10), (50, 5), (1, 99), (2, 1)):
        start = int(rng.integers(1, NUM_ITEMS - 120))
        items = rng.choice(np.arange(start, start + 100), n_unique, replace=False).tolist()
        out.append((items + items[: n_unique // 3], k))
    return out


@pytest.mark.parametrize("case", range(len(_sessions())))
def test_int8_recommend_matches_the_jax_int8_path(recommenders, case):
    jax_r, port_r = recommenders
    items, k = _sessions()[case]
    want_ids, want_scores = jax_r.recommend(JaxRequest(session_items=items, k=k))
    got_ids, got_scores = port_r.recommend(PortRequest(session_items=items, k=k))
    assert got_ids == want_ids
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5, atol=1e-5)
    assert len(got_ids) == k and not set(got_ids) & set(items) and 0 not in got_ids
    assert all(i < NUM_ITEMS for i in got_ids)
    assert all(a >= b for a, b in zip(got_scores, got_scores[1:]))


def test_int8_path_equals_the_exact_path(checkpoints, recommenders):
    """At a margin of 1,024 candidates the re-ranked int8 top-k is the exact top-k."""
    _, port_path, edges = checkpoints
    _, int8 = recommenders
    exact = port_rec.Recommender(port_path, edges, buckets=BUCKETS, warmup=False, device="cpu", int8_scoring=False)
    assert not exact.int8_scoring
    for items, k in _sessions():
        got_ids, got_scores = int8.recommend(PortRequest(session_items=items, k=k))
        want_ids, want_scores = exact.recommend(PortRequest(session_items=items, k=k))
        assert got_ids == want_ids
        np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5, atol=1e-5)


def test_health_reports_the_int8_path_and_the_phantom_rows_never_score(recommenders):
    _, port_r = recommenders
    h = port_r.health()
    assert h["int8_scoring"] is True and h["device"] == "cpu"
    assert port_r._q_scale[0] == 0.0 and not port_r._q_scale[NUM_ITEMS:].any()
    assert port_r._table_np.shape == (3072, 16)


@pytest.fixture(scope="module")
def large_checkpoint(tmp_path_factory):
    """A 100,000-item port checkpoint (100,352 rows) at width 8."""
    out = tmp_path_factory.mktemp("int8_large")
    model = registry.create_model("graph_transformer_optimized", port_rec.FAST_SCORING_MIN_ROWS, device="cpu",
                                  embedding_dim=8, hidden_dim=8, laplacian_k=4,
                                  generator=torch.Generator().manual_seed(0))
    port_ckpt.save(out / "ckpt", model, epoch=0, best_val_metric=0.0)
    return out / "ckpt", _edges(np.random.default_rng(1), port_rec.FAST_SCORING_MIN_ROWS, out / "edges.npz")


def test_auto_chooses_int8_on_the_cpu_from_100000_rows(large_checkpoint, checkpoints):
    path, edges = large_checkpoint
    rec = port_rec.Recommender(path, edges, warmup=True, device="cpu")
    assert rec.int8_scoring is True and rec.health()["int8_scoring"] is True
    ids, scores = rec.recommend(PortRequest(session_items=[10, 11, 12], k=10))
    exact = port_rec.Recommender(path, edges, warmup=False, device="cpu", int8_scoring=False)
    want_ids, want_scores = exact.recommend(PortRequest(session_items=[10, 11, 12], k=10))
    assert ids == want_ids
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-5)
    _, small_path, small_edges = checkpoints
    small = port_rec.Recommender(small_path, small_edges, warmup=False, device="cpu")
    assert small.int8_scoring is False and small.health()["int8_scoring"] is False


def test_auto_without_the_library_scores_in_float32_and_true_raises(checkpoints, large_checkpoint, monkeypatch):
    path, edges = large_checkpoint
    monkeypatch.setattr(port_native, "available", lambda: False)
    assert port_rec.Recommender(path, edges, warmup=False, device="cpu").int8_scoring is False
    _, small_path, small_edges = checkpoints
    with pytest.raises(RuntimeError, match="int8_scoring=True"):
        port_rec.Recommender(small_path, small_edges, warmup=False, device="cpu", int8_scoring=True)
    with pytest.raises(ValueError, match="int8_scoring"):
        port_rec.Recommender(small_path, small_edges, warmup=False, device="cpu", int8_scoring="yes")


def test_latency_bench_measures_the_int8_mode_on_the_cpu(large_checkpoint):
    path, edges = large_checkpoint
    results = latency_bench.run(path, edges, num_requests=20, device="cpu")
    assert results["device"] == "cpu" and results["card"] is None
    for mode in ("exact", "int8"):
        got = results[mode]
        assert got["n"] == 20 and 0 < got["p50"] <= got["p95"] <= got["p99"] and got["load_warmup_s"] > 0
