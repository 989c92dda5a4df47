"""The port's FastAPI transport (``serving/app.py::create_app``) against the JAX package's.

fastapi is installed neither here nor on the GPU host, so both packages'
``create_app`` run under a stand-in ``fastapi`` module: a ``FastAPI`` that
records its title, version, lifespan and routes, ``HTTPException`` and a
``Request`` whose ``json()`` returns the body. Both apps must register the
same routes, title and version; their lifespans load the default
recommender on entry and drop it on exit; ``GET /health`` and ``POST
/recommend`` answer with EQUAL payloads (but for ``latency_ms``) from the
same stand-in recommender; a status other than 200 raises the same
``HTTPException`` (status and detail). Without fastapi the module's ``app``
is None, with it an app; fastapi is imported only inside ``create_app``.
"""

from __future__ import annotations

import ast
import asyncio
import importlib.util
import sys
import types
from pathlib import Path

import pytest

from gat_recommendation_torch.serving import app as port_app
from gat_recommendation_tpu.serving import app as jax_app

APPS = {"port": port_app, "jax": jax_app}
NUM_ITEMS = 50


class _HTTPException(Exception):
    def __init__(self, status_code: int, detail=None):
        super().__init__(status_code, detail)
        self.status_code, self.detail = status_code, detail


class _Request:
    def __init__(self, body):
        self._body = body

    async def json(self):
        return self._body


class _FastAPI:
    def __init__(self, title: str, version: str, lifespan=None):
        self.title, self.version, self.lifespan = title, version, lifespan
        self.routes: dict[tuple[str, str], object] = {}

    def _route(self, method: str, path: str):
        def register(fn):
            self.routes[(method, path)] = fn
            return fn
        return register

    def get(self, path: str):
        return self._route("GET", path)

    def post(self, path: str):
        return self._route("POST", path)


def _stand_in() -> types.ModuleType:
    module = types.ModuleType("fastapi")
    module.FastAPI, module.HTTPException, module.Request = _FastAPI, _HTTPException, _Request
    return module


class _Recommender:
    """The fields /health reads and a recommend() that answers from the request alone."""

    num_items, embedding_dim, checkpoint_epoch, val_recall_at_10 = NUM_ITEMS, 16, 7, 0.4

    def recommend(self, validated):
        ids = [i for i in range(1, NUM_ITEMS) if i not in validated.session_items][:validated.k]
        return ids, [1.0 / (1 + r) for r in range(len(ids))]


@pytest.fixture
def apps(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastapi", _stand_in())
    for module in APPS.values():
        monkeypatch.setattr(module, "_state", {"recommender": None})
    return {label: module.create_app() for label, module in APPS.items()}


def test_both_apps_register_the_same_routes_title_and_version(apps):
    port, jax = apps["port"], apps["jax"]
    assert isinstance(port, _FastAPI) and isinstance(jax, _FastAPI)
    assert (port.title, port.version) == (jax.title, jax.version) == ("Session Recommendation API", "2.0.0")
    assert list(port.routes) == list(jax.routes) == [("GET", "/health"), ("POST", "/recommend")]
    assert port.lifespan is not None and jax.lifespan is not None


async def _call(app, method: str, body=None):
    """(status, payload) of one route call; an HTTPException's status and detail."""
    route = app.routes[(method, "/health" if method == "GET" else "/recommend")]
    try:
        payload = route() if method == "GET" else await route(_Request(body))
    except _HTTPException as e:
        return e.status_code, {"detail": e.detail}
    return 200, payload


def _answer(app, method: str, body=None):
    return asyncio.run(_call(app, method, body))


def _lifespan(app, module) -> tuple:
    """Whether a recommender was loaded inside the lifespan, and after it."""
    async def run():
        async with app.lifespan(app):
            inside = module._state["recommender"]
        return inside, module._state["recommender"]
    return asyncio.run(run())


def test_the_lifespan_loads_the_default_recommender_and_drops_it(apps, monkeypatch):
    for label, module in APPS.items():
        stub = _Recommender()
        monkeypatch.setattr(module, "load_default_recommender", lambda m=module, s=stub: m.set_recommender(s))
        assert _lifespan(apps[label], module) == (stub, None)


def test_without_a_model_health_is_unavailable_and_recommend_503(apps, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)  # no checkpoint here: the default loader keeps the app alive without a model
    answers = {}
    for label, app in apps.items():

        async def inside(app=app):
            async with app.lifespan(app):
                return await _call(app, "GET"), await _call(app, "POST", {"session_items": [1, 2]})

        answers[label] = asyncio.run(inside())
    assert "model not loaded" in capsys.readouterr().out
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] == (200, {"status": "unavailable", "model_loaded": False, "num_items": 0,
                                         "embedding_dim": 0})
    assert answers["port"][1] == (503, {"detail": "Model is not loaded."})


BODIES = {
    "ok": {"session_items": [3, 1, 4, 1, 5], "k": 4},
    "default_k": {"session_items": [7]},
    "dropped_ids": {"session_items": [2, 10 ** 6, -3, 9]},
    "no_items_key": {"items": [1]},
    "items_not_a_list": {"session_items": "1,2"},
    "k_not_an_integer": {"session_items": [1], "k": "5"},
    "k_a_bool": {"session_items": [1], "k": True},
    "no_valid_id": {"session_items": [10 ** 6]},
    "k_below_one": {"session_items": [1], "k": 0},
    "not_an_object": [1, 2],
}


@pytest.mark.parametrize("case", BODIES)
def test_both_apps_answer_alike(apps, case):
    stub = _Recommender()
    answers = {}
    for label, module in APPS.items():
        module.set_recommender(stub)
        health = _answer(apps[label], "GET")
        status, payload = _answer(apps[label], "POST", BODIES[case])
        if status == 200:
            assert payload.pop("latency_ms") >= 0.0
        answers[label] = (health, status, payload)
    assert answers["port"] == answers["jax"]
    health, status, payload = answers["port"]
    assert health == (200, {"status": "ok", "model_loaded": True, "num_items": NUM_ITEMS, "embedding_dim": 16,
                            "checkpoint_epoch": 7, "val_recall_at_10": 0.4})
    assert (status == 200) == (case in ("ok", "default_k", "dropped_ids")), (status, payload)
    if status != 200:
        assert status == 422 and isinstance(payload["detail"], str)


def _fresh_copy(module, name: str):
    spec = importlib.util.spec_from_file_location(name, module.__file__)
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    return copy


@pytest.mark.parametrize("label", APPS)
def test_app_is_none_without_fastapi_and_an_app_with_it(label, monkeypatch):
    monkeypatch.setitem(sys.modules, "fastapi", None)  # import fastapi raises ImportError
    assert _fresh_copy(APPS[label], f"_app_without_fastapi_{label}").app is None
    monkeypatch.setitem(sys.modules, "fastapi", _stand_in())
    app = _fresh_copy(APPS[label], f"_app_with_fastapi_{label}").app
    assert isinstance(app, _FastAPI) and list(app.routes) == [("GET", "/health"), ("POST", "/recommend")]


def test_the_port_imports_fastapi_only_inside_create_app():
    tree = ast.parse(Path(port_app.__file__).read_text())
    importers = {node.name for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)
                 for inner in ast.walk(node)
                 if isinstance(inner, ast.ImportFrom) and inner.module == "fastapi"}
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom)) and "fastapi" in ast.dump(n)]
    assert importers == {"create_app"} and top == []
