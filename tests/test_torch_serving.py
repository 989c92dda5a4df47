"""The port's serving path vs the JAX package's exact serving path.

One JAX checkpoint (initialised, perturbed, not trained) is served by the
JAX ``Recommender(int8_scoring=False)``; the same weights, carried across by
``convert.from_jax_params`` and saved in the port's format, are served by the
port's ``Recommender(device="cpu")``. Item ids must be EQUAL, scores within
1e-5 (float32, summation order differs), for requests in every bucket.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch import convert
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.serving import app as port_app
from gat_recommendation_torch.serving import recommender as port_rec
from gat_recommendation_torch.serving.validation import ValidatedRequest as PortRequest
from gat_recommendation_torch.train import checkpoint as port_ckpt
from gat_recommendation_tpu.serving import app as jax_app
from gat_recommendation_tpu.serving.validation import ValidatedRequest as JaxRequest

torch.set_num_threads(1)

NUM_ITEMS = 300  # table padded to 512 rows: 16 chunks of 32
BUCKETS = (8, 16, 32, 56)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    from gat_recommendation_tpu.models import create_model
    from gat_recommendation_tpu.train import checkpoint as jax_ckpt

    out = tmp_path_factory.mktemp("serving")
    model = create_model(
        "graph_transformer_optimized", num_items=NUM_ITEMS, embedding_dim=16,
        hidden_dim=16, laplacian_k=4,
    )
    params, state = model.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    state = jax.tree.map(np.asarray, state)
    for bn in state["batch_norms"]:
        bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    state["cached_pe"] = rng.normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    meta = {"epoch": 3, "best_val_metric": 0.25, "model_name": model.name,
            "model_config": dataclasses.asdict(model.config)}
    jax_ckpt.save(out / "jax_ckpt", params, state, {"dummy": np.zeros(1)}, meta)

    item_i = rng.integers(1, NUM_ITEMS, 3000)
    item_j = rng.integers(1, NUM_ITEMS, 3000)
    item_j[:50] = item_i[:50]  # self-loops, dropped by both recommenders
    edges = out / "graph_edges.csv"
    pd.DataFrame({"item_i": item_i, "item_j": item_j}).to_csv(edges, index=False)

    weights, buffers = convert.from_jax_params(
        jax.tree.map(np.asarray, params), state, meta["model_config"]
    )
    cfg = dict(meta["model_config"])
    port_model = registry.create_model(model.name, cfg.pop("num_items"), device="cpu", **cfg)
    port_model.load_state_dict({**weights, **buffers})
    port_ckpt.save(out / "port_ckpt", port_model, epoch=3, best_val_metric=0.25)
    return out / "jax_ckpt", out / "port_ckpt", edges


@pytest.fixture(scope="module")
def recommenders(checkpoints):
    from gat_recommendation_tpu.serving.recommender import Recommender as JaxRecommender

    jax_path, port_path, edges = checkpoints
    jax_r = JaxRecommender(jax_path, edges, buckets=BUCKETS, warmup=False, int8_scoring=False)
    port_r = port_rec.Recommender(port_path, edges, buckets=BUCKETS, warmup=False, device="cpu")
    return jax_r, port_r


def _sessions():
    rng = np.random.default_rng(5)
    out = []
    for n_unique, k in ((3, 10), (6, 20), (12, 10), (25, 15), (40, 10), (50, 5), (1, 99)):
        items = rng.choice(np.arange(1, NUM_ITEMS), n_unique, replace=False).tolist()
        out.append((items + items[: n_unique // 3], k))  # repeats: unique count picks the bucket
    return out


@pytest.mark.parametrize("case", range(len(_sessions())))
def test_recommend_matches_jax_exact_path(recommenders, case):
    jax_r, port_r = recommenders
    items, k = _sessions()[case]
    want_ids, want_scores = jax_r.recommend(JaxRequest(session_items=items, k=k))
    got_ids, got_scores = port_r.recommend(PortRequest(session_items=items, k=k))
    assert got_ids == want_ids
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5, atol=1e-5)
    assert not set(got_ids) & set(items) and 0 not in got_ids
    assert all(i < NUM_ITEMS for i in got_ids)


def test_every_bucket_is_exercised(recommenders):
    _, port_r = recommenders
    from gat_recommendation_torch.data.batching import pick_bucket

    used = {pick_bucket(len(set(items)), BUCKETS) for items, _ in _sessions()}
    assert used == set(BUCKETS)


def test_health_and_warmup(checkpoints, recommenders):
    _, port_path, edges = checkpoints
    rec = port_rec.Recommender(port_path, edges, buckets=(8, 16), warmup=True, device="cpu")
    h = rec.health()
    assert h["num_items"] == NUM_ITEMS and h["embedding_dim"] == 16
    assert h["checkpoint_epoch"] == 3 and h["val_recall_at_10"] == 0.25
    assert h["device"] == "cpu"
    # Every key the JAX server's GET /health sends. "auto" on the CPU below
    # FAST_SCORING_MIN_ROWS rows scores in float32, as the JAX rule says.
    jax_r, _ = recommenders
    assert set(jax_r.health()) <= set(h)
    assert NUM_ITEMS < port_rec.FAST_SCORING_MIN_ROWS
    assert h["int8_scoring"] is False and rec.int8_scoring is False


BODIES = [
    ("POST", "/recommend", {"session_items": [1, 2, 3], "k": 5}),
    ("POST", "/recommend", {"session_items": [4, 9999, 5]}),
    ("POST", "/recommend", {"session_items": list(range(1, 80)), "k": 500}),
    ("POST", "/recommend", {"session_items": []}),
    ("POST", "/recommend", {"session_items": [9999]}),
    ("POST", "/recommend", {"wrong": 1}),
    ("POST", "/recommend", {"session_items": "abc"}),
    ("POST", "/recommend", {"session_items": [1], "k": "x"}),
    ("POST", "/recommend", {"session_items": [1], "k": True}),
    ("POST", "/recommend", {"session_items": [1], "k": 0}),
    ("POST", "/recommend", {"session_items": [1.5]}),
    ("POST", "/recommend", None),
    ("GET", "/health", None),
    ("GET", "/nope", None),
]


@pytest.fixture
def both_apps(recommenders):
    jax_r, port_r = recommenders
    jax_app.set_recommender(jax_r)
    port_app.set_recommender(port_r)
    yield
    jax_app.set_recommender(None)
    port_app.set_recommender(None)


def test_handle_request_statuses_match_jax_app(both_apps):
    for method, path, body in BODIES:
        want_status, want = jax_app.handle_request(method, path, body)
        got_status, got = port_app.handle_request(method, path, body)
        assert got_status == want_status, (method, path, body)
        if got_status == 200 and path == "/recommend":
            assert got["recommendations"] == want["recommendations"]
            assert got["dropped_items"] == want["dropped_items"]
            assert got["truncated"] == want["truncated"]
    port_app.set_recommender(None)
    jax_app.set_recommender(None)
    for method, path, body in (BODIES[0], BODIES[-2]):
        assert port_app.handle_request(method, path, body)[0] == jax_app.handle_request(method, path, body)[0]
    assert port_app.handle_request("POST", "/recommend", {"session_items": [1]})[0] == 503


def test_http_transport(both_apps):
    server = port_app.make_server(load_model=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{url}/health") as r:
            assert json.loads(r.read())["model_loaded"] is True
        req = urllib.request.Request(
            f"{url}/recommend", data=json.dumps({"session_items": [3, 4], "k": 3}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as r:
            payload = json.loads(r.read())
        assert len(payload["recommendations"]) == 3
        bad = urllib.request.Request(f"{url}/recommend", data=b"{not json", method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_rejects_ffn_checkpoint(checkpoints, tmp_path):
    _, port_path, edges = checkpoints
    meta = port_ckpt.load_meta(port_path)
    meta["model_config"]["use_ffn"] = True
    (tmp_path / "ffn").mkdir()
    (tmp_path / "ffn" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="FFN"):
        port_rec.Recommender(tmp_path / "ffn", edges, warmup=False, device="cpu")


def test_checkpoint_manifest_mismatch_raises(checkpoints):
    _, port_path, _ = checkpoints
    model = registry.create_model(
        "graph_transformer_optimized", NUM_ITEMS, embedding_dim=16, hidden_dim=16,
        laplacian_k=4, num_layers=3, device="cpu",
    )
    with pytest.raises(ValueError, match="manifest"):
        port_ckpt.restore_params_state(port_path, model)


def test_default_device_is_cuda_and_raises_without_it(checkpoints, monkeypatch):
    _, port_path, edges = checkpoints
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_rec.Recommender(port_path, edges, warmup=False)


@pytest.mark.parametrize("name,kw", [("gat", {}), ("graphsage", {"aggregator": "mean"})])
def test_gat_and_graphsage_checkpoints_serve_the_jax_recommenders_top_k(checkpoints, tmp_path, name, kw):
    """A GAT or GraphSAGE checkpoint (JAX weights carried by convert.py, the
    BatchNorm statistics perturbed) loads by its model name into the port's
    Recommender on the CPU and serves the JAX exact path's ids, scores within
    1e-5, over requests in every bucket."""
    from gat_recommendation_tpu.models import create_model
    from gat_recommendation_tpu.serving.recommender import Recommender as JaxRecommender
    from gat_recommendation_tpu.train import checkpoint as jax_ckpt

    _, _, edges = checkpoints
    model = create_model(name, num_items=NUM_ITEMS, embedding_dim=16, hidden_dim=16, **kw)
    params, state = model.init_params(jax.random.key(1))
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(1)
    for bn in state["batch_norms"]:
        bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    meta = {"epoch": 1, "best_val_metric": 0.5, "model_name": name, "model_config": dataclasses.asdict(model.config)}
    jax_ckpt.save(tmp_path / "jax", params, state, {"dummy": np.zeros(1)}, meta)
    weights, buffers = convert.from_jax_params(jax.tree.map(np.asarray, params), state, meta["model_config"], name)
    cfg = dict(meta["model_config"])
    port_model = registry.create_model(name, cfg.pop("num_items"), device="cpu", **cfg)
    port_model.load_state_dict({**weights, **buffers})
    port_ckpt.save(tmp_path / "port", port_model, epoch=1, best_val_metric=0.5)

    jax_r = JaxRecommender(tmp_path / "jax", edges, buckets=BUCKETS, warmup=False, int8_scoring=False)
    port_r = port_rec.Recommender(tmp_path / "port", edges, buckets=BUCKETS, warmup=False, device="cpu")
    assert port_r.model.name == name and not port_r.model.training
    for items, k in _sessions():
        want_ids, want_scores = jax_r.recommend(JaxRequest(session_items=items, k=k))
        got_ids, got_scores = port_r.recommend(PortRequest(session_items=items, k=k))
        assert got_ids == want_ids
        np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5, atol=1e-5)
