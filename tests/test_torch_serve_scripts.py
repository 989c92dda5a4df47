"""The port's dev and Vertex-style servers against the repo's scripts/serve/.

``MeanEmbeddingModel`` (the table on the CPU here) must give the JAX
script's ids, scores within 1e-6, on the same table (the demo's seeded
numpy draw, an ``.npy`` file, and one checkpoint carried across by
``convert.from_jax_params``). The scores are distinct, so the port's stable
sort and the script's ``np.argsort`` agree. ``handle`` must give the same
status and body for every route and error case of both servers
(``latency_ms`` compared by key only), and each server answers one real
HTTP round trip on port 0.

The Vertex server registers its ``Metrics`` at import, in prometheus_client's
default registry, which holds one metric of a name per process (and the JAX
script's own tests register the same names). So each package's Vertex
server runs in a fresh interpreter of its own, which prints every answer.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gat_recommendation_torch import convert
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.scripts import bench_scoring
from gat_recommendation_torch.scripts.serve import app as port_app
from gat_recommendation_torch.train import checkpoint as port_ckpt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SERVE_DIR = REPO / "scripts" / "serve"
SCORE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_app():
    spec = importlib.util.spec_from_file_location("jax_dev_server_app", SERVE_DIR / "app.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_body(got, want):
    """Equal bodies, but scores within SCORE_TOL and latency_ms by key only."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (got, want)
        for key, value in want.items():
            if key == "latency_ms":
                assert isinstance(got[key], float) and got[key] >= 0
            elif key == "scores":
                np.testing.assert_allclose(got[key], value, **SCORE_TOL)
                assert len(got[key]) == len(value)
            else:
                _same_body(got[key], value)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _same_body(g, w)
    else:
        assert got == want


DEV_CASES = [
    ("GET", "/health", None),
    ("POST", "/recommend", {"session_items": [1, 2, 3], "k": 7}),
    ("POST", "/recommend", {"session_items": [5, 5, 9]}),
    ("POST", "/recommend", {"session_items": [7, 0, 250, 12], "k": 3}),
    ("POST", "/recommend", {"session_items": [1], "k": 0}),
    ("POST", "/recommend", {"session_items": [1], "k": "4"}),
    ("POST", "/recommend", {"session_items": []}),
    ("POST", "/recommend", {}),
    ("POST", "/recommend", None),
    ("POST", "/recommend", {"session_items": "abc"}),
    ("POST", "/recommend", {"session_items": [9999]}),
    ("POST", "/recommend", {"session_items": [1, 2], "k": "x"}),
    ("POST", "/recommend/batch", {"sessions": [[1, 2], [5], [99999]], "k": 3}),
    ("POST", "/recommend/batch", {"sessions": []}),
    ("POST", "/recommend/batch", {"sessions": "no"}),
    ("GET", "/nope", None),
    ("POST", "/health", None),
]


@pytest.mark.parametrize("case", range(len(DEV_CASES)))
def test_dev_handle_matches_the_script(jax_app, case):
    method, path, body = DEV_CASES[case]
    got_model = port_app.MeanEmbeddingModel.demo(num_items=200, dim=16, device="cpu")
    want_model = jax_app.MeanEmbeddingModel.demo(num_items=200, dim=16)
    got = port_app.handle(got_model, method, path, body)
    want = jax_app.handle(want_model, method, path, body)
    assert got[0] == want[0]
    _same_body(got[1], want[1])


def test_mean_embedding_model_matches_the_script(jax_app, tmp_path):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((500, 24)).astype(np.float32)
    np.save(tmp_path / "items.npy", table)
    got_m = port_app.MeanEmbeddingModel.from_npy(str(tmp_path / "items.npy"), device="cpu")
    want_m = jax_app.MeanEmbeddingModel.from_npy(str(tmp_path / "items.npy"))
    assert (got_m.num_items, got_m.embedding_dim) == (want_m.num_items, want_m.embedding_dim) == (500, 24)
    for trial in range(20):
        items = rng.integers(-3, 520, int(rng.integers(1, 12))).tolist()
        k = int(rng.integers(1, 60))
        if not [i for i in items if 0 < i < 500]:
            with pytest.raises(ValueError, match="no valid item ids"):
                got_m.recommend(items, k)
            continue
        got_ids, got_scores = got_m.recommend(items, k)
        want_ids, want_scores = want_m.recommend(items, k)
        assert got_ids == want_ids, trial
        np.testing.assert_allclose(got_scores, want_scores, **SCORE_TOL)
        assert not set(got_ids) & set(items) and 0 not in got_ids


def test_stable_order_of_tied_scores():
    """Identical rows tie: the lower id comes first."""
    table = np.zeros((6, 4), np.float32)
    table[1:, 0] = 1.0
    ids, scores = port_app.MeanEmbeddingModel(table, device="cpu").recommend([1], 3)
    assert ids == [2, 3, 4] and scores == [1.0, 1.0, 1.0]


def test_from_checkpoint_reads_the_port_checkpoint_of_the_same_weights(jax_app, tmp_path):
    from gat_recommendation_tpu.models import create_model
    from gat_recommendation_tpu.train import checkpoint as jax_ckpt

    model = create_model("graph_transformer_optimized", num_items=300, embedding_dim=16, hidden_dim=16,
                         laplacian_k=4)
    params, state = model.init_params(jax.random.key(2))
    meta = {"epoch": 1, "best_val_metric": 0.1, "model_name": model.name,
            "model_config": dataclasses.asdict(model.config)}
    jax_ckpt.save(tmp_path / "jax", params, state, {"dummy": np.zeros(1)}, meta)
    weights, buffers = convert.from_jax_params(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
                                               meta["model_config"])
    cfg = dict(meta["model_config"])
    port_model = registry.create_model(model.name, cfg.pop("num_items"), device="cpu", **cfg)
    port_model.load_state_dict({**weights, **buffers})
    port_ckpt.save(tmp_path / "port", port_model, epoch=1, best_val_metric=0.1)

    got = port_app.MeanEmbeddingModel.from_checkpoint(str(tmp_path / "port"), device="cpu")
    want = jax_app.MeanEmbeddingModel.from_checkpoint(str(tmp_path / "jax"))
    assert got.num_items == want.num_items == 512
    np.testing.assert_array_equal(got.item_embeddings.numpy(), want.item_embeddings)
    got_ids, got_scores = got.recommend([3, 40, 41], 10)
    want_ids, want_scores = want.recommend([3, 40, 41], 10)
    assert got_ids == want_ids
    np.testing.assert_allclose(got_scores, want_scores, **SCORE_TOL)


def test_dev_server_http_round_trip():
    server = port_app.make_server(port_app.MeanEmbeddingModel.demo(num_items=200, dim=16, device="cpu"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{url}/health", timeout=30) as r:
            assert json.loads(r.read())["num_items"] == 200
        for path, body, n in (("/recommend", {"session_items": [3, 4], "k": 3}, 3),
                              ("/recommend/batch", {"sessions": [[3], [4, 5]], "k": 2}, 2)):
            req = urllib.request.Request(f"{url}{path}", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                payload = json.loads(r.read())
            assert len(payload.get("recommendations", payload.get("results"))) == n
        bad = urllib.request.Request(f"{url}/recommend", data=b"{not json", method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


VERTEX_CASES = [
    ("GET", "/health", None),
    ("POST", "/predict", {"instances": [{"session_items": [1, 2], "k": 3}, {"session_items": [], "k": 3},
                                        {"session_items": [4]}, {"session_items": [5], "k": "x"},
                                        {"session_items": [99999]}]}),
    ("POST", "/predict", {"instances": "nope"}),
    ("POST", "/predict", None),
    ("POST", "/recommend", {"session_items": [1, 2, 3], "k": 5}),
    ("POST", "/recommend", {"session_items": [7, 7]}),
    ("POST", "/recommend", {"session_items": []}),
    ("POST", "/recommend", {"session_items": [9999999]}),
    ("POST", "/recommend", {"session_items": [1], "k": "x"}),
    ("POST", "/recommend", {"session_items": [1], "k": None}),
    ("POST", "/recommend/batch", {"sessions": [[1, 2], [5], [99999]], "k": 3}),
    ("POST", "/recommend/batch", {"sessions": {}}),
    ("GET", "/drift", None),
    ("GET", "/metrics", None),
    ("GET", "/nope", None),
]

_VERTEX_PROBE = """
import importlib.util, json, sys, threading, urllib.error, urllib.request
which, cases = sys.argv[1], json.loads(sys.argv[2])
if which == "port":
    from gat_recommendation_torch.scripts.serve import vertex_app as v
    model = v.load_model("cpu")
else:
    sys.path.insert(0, "scripts/serve")
    spec = importlib.util.spec_from_file_location("jax_vertex_app", "scripts/serve/vertex_app.py")
    v = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(v)
    model = v.load_model()
answers = []
for method, path, body in cases:
    status, payload = v.handle(model, method, path, body)
    if isinstance(payload, bytes):
        payload = sorted(line.split()[2] for line in payload.decode().splitlines() if line.startswith("# TYPE"))
    answers.append([status, payload])
server = v.make_server(model, "127.0.0.1", 0)
thread = threading.Thread(target=server.serve_forever, daemon=True)
thread.start()
url = f"http://127.0.0.1:{server.server_address[1]}"
http = []
try:
    for method, path, body in cases:
        data = None if body is None and method == "GET" else json.dumps(body).encode()
        req = urllib.request.Request(url + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                http.append([r.status, r.headers.get("Content-Type")])
        except urllib.error.HTTPError as e:
            http.append([e.code, e.headers.get("Content-Type")])
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        scraped = r.read().decode()
finally:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
print(json.dumps({"answers": answers, "http": http, "enabled": v.metrics.enabled, "alive": thread.is_alive(),
                  "counted": sorted(l.split(" ")[0] for l in scraped.splitlines()
                                    if l.startswith("recommend_requests_total"))}))
"""


@pytest.fixture(scope="module")
def vertex_runs(tmp_path_factory):
    runs = {}
    env = {**__import__("os").environ, "INFERENCE_MODE": "demo"}
    for which in ("port", "jax"):
        out = subprocess.run([sys.executable, "-c", _VERTEX_PROBE, which, json.dumps(VERTEX_CASES)], cwd=REPO,
                             env=env, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr
        runs[which] = json.loads(out.stdout.strip().splitlines()[-1])
    return runs


@pytest.mark.parametrize("case", range(len(VERTEX_CASES)))
def test_vertex_handle_matches_the_script(vertex_runs, case):
    got, want = vertex_runs["port"]["answers"][case], vertex_runs["jax"]["answers"][case]
    assert got[0] == want[0]
    _same_body(got[1], want[1])


def test_vertex_server_http_round_trip_and_metrics(vertex_runs):
    got, want = vertex_runs["port"], vertex_runs["jax"]
    assert got["http"] == want["http"]
    assert [status for status, _ in got["http"]] == [a[0] for a in got["answers"]]
    assert got["enabled"] is want["enabled"] is True
    assert got["counted"] == want["counted"] and got["alive"] is False
    drift = got["answers"][[path for _, path, _ in VERTEX_CASES].index("/drift")][1]
    assert drift["requests_seen"] > 0


def test_bench_scoring_runs_once_on_the_cpu(capsys):
    out = bench_scoring.main(["--batch-size", "3", "--num-items", "20000", "--steps", "2", "--device", "cpu"])
    assert out["device"] == "cpu" and out["card"] is None and out["rows"] == 20_480
    assert set(out["ms"]) == {"matmul_only", "dense", "two_level", "two_level_nomask", "approx",
                              "two_level_c8", "two_level_c16", "two_level_c64"}
    assert all(np.isfinite(v) for v in out["ms"].values())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ms"] == out["ms"]


def test_servers_and_bench_ask_for_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_app.MeanEmbeddingModel.demo(num_items=20, dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scoring.run(2, 20_000, steps=1)
