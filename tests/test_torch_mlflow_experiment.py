"""The port's ``mlflow_experiment`` against the repo's ``scripts/pipeline/mlflow_experiment.py``, on the CPU.

The JAX script is loaded from ``scripts/`` and run in-process
(``tests/quickstart_torch.py``), once for the module with all four models.
Both scripts train with dropout 0, patched into their ``create_model`` (the
packages draw dropout masks from different streams), and the port's models
start from the JAX script's weights (``init_params(key(0))``, carried over
by ``convert.from_jax_params``). Tolerances:

- ``run.json`` params (model, lr, epochs, the parameter count, the
  description), the run names and the tracker's registry and flags: EQUAL.
- each epoch's ``train_loss``: within LOSS_TOL (float32 on both sides,
  summation orders differ).
- under a recording stand-in ``mlflow`` module both scripts make the same
  calls with the same arguments (the logged losses within LOSS_TOL).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from quickstart_torch import load_jax_script

from gat_recommendation_torch import convert
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.scripts.pipeline import mlflow_experiment
from gat_recommendation_torch.smoke_test_all_models import make_synthetic_batches
from gat_recommendation_tpu import models as jax_models
from gat_recommendation_tpu.data import batching as jax_batching

torch.set_num_threads(1)

LOSS_TOL = 1e-5
FIELDS = ("node_ids", "node_mask", "adj", "num_nodes", "targets", "negatives", "sample_mask")


def _jax_create_at_dropout_0(create):
    return lambda name, num_items, **kw: create(name, num_items, **{**kw, "dropout": 0.0})


def _port_create_from_jax_weights(create):
    """The port's create_model at dropout 0, filled with the weights the JAX
    script draws for the same model (its encodings are computed again by
    the script's precompute_pe)."""
    def build(name, num_items, device=None, **kw):
        kw = {**kw, "dropout": 0.0}
        model = create(name, num_items, device=device, **kw)
        jax_model = jax_models.create_model(name, num_items, **kw)
        params, state = jax_model.init_params(jax.random.key(0))
        weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(jax_model.config), name)
        model.load_state_dict({**weights, **buffers})
        return model

    return build


def _patch_both(monkeypatch) -> None:
    monkeypatch.setattr(jax_models, "create_model", _jax_create_at_dropout_0(jax_models.create_model))
    monkeypatch.setattr(mlflow_experiment, "create_model",
                        _port_create_from_jax_weights(mlflow_experiment.create_model))


def _runs(tracking: Path) -> dict[str, dict]:
    runs = {}
    for path in sorted(tracking.glob("session-recommendation/*/run.json")):
        run = json.loads(path.read_text())
        assert path.parent.name.startswith(run["run_name"] + "-")
        runs[run["run_name"]] = run
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts' run.json for the four models (the JAX script's collated
    batches kept), at dropout 0 from the same weights."""
    root = tmp_path_factory.mktemp("tracked")
    kept: list = []
    with pytest.MonkeyPatch.context() as mp:
        _patch_both(mp)
        collate = jax_batching.collate
        mp.setattr(jax_batching, "collate", lambda *a: kept.append(collate(*a)) or kept[-1])
        mp.setattr(sys, "argv", ["mlflow_experiment.py", "--tracking-dir", str(root / "jax")])
        mp.setenv("GAT_REC_COMPILE_CACHE", "off")
        jax_module = load_jax_script("pipeline/mlflow_experiment.py")
        jax_module.main()
        results = mlflow_experiment.main(["--tracking-dir", str(root / "port"), "--device", "cpu"])
    return _runs(root / "jax"), _runs(root / "port"), kept, jax_module, results


def test_the_registry_and_flags_are_the_jax_scripts(runs):
    jax_module = runs[3]
    assert mlflow_experiment.MODEL_REGISTRY == jax_module.MODEL_REGISTRY
    assert list(mlflow_experiment.MODEL_REGISTRY) == list(registry.MODEL_NAMES)
    port = vars(mlflow_experiment.parse_args([]))
    assert port.pop("device") is None
    assert port == {"models": list(jax_module.MODEL_REGISTRY), "tracking_dir": "mlruns",
                    "experiment": "session-recommendation", "epochs": 2, "lr": 1e-3}


def test_the_batches_are_the_jax_scripts(runs):
    kept = runs[2]
    assert len(kept) == 4 * 4  # four batches for each model, drawn anew from default_rng(0)
    for want, got in zip(kept[:4], make_synthetic_batches(4, 16), strict=True):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("name", registry.MODEL_NAMES)
def test_each_run_logs_the_jax_runs_params_and_losses(name, runs):
    want, got = runs[0][name], runs[1][name]
    assert got["params"] == want["params"]
    assert got["params"]["num_params"] == want["params"]["num_params"] != "0"
    assert (got["tags"], want["tags"]) == ({}, {})
    w, g = want["metrics"]["train_loss"], got["metrics"]["train_loss"]
    assert [m["step"] for m in g] == [m["step"] for m in w] == [0, 1]
    np.testing.assert_allclose([m["value"] for m in g], [m["value"] for m in w], rtol=LOSS_TOL, atol=LOSS_TOL)
    assert runs[4][name]["finite"] and runs[4][name]["final_loss"] > 0


class _RecordingMlflow(types.ModuleType):
    """A stand-in ``mlflow``: records each call, with its arguments."""

    def __init__(self):
        super().__init__("mlflow")
        self.calls: list = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            if name == "start_run":
                return types.SimpleNamespace(
                    __exit__=lambda *a: self.calls.append(("run.__exit__", a, {})))
            return None

        return call


def _recorded(run, monkeypatch) -> list:
    stand_in = _RecordingMlflow()
    monkeypatch.setitem(sys.modules, "mlflow", stand_in)
    run()
    return stand_in.calls


def test_under_mlflow_both_scripts_make_the_same_calls(tmp_path, monkeypatch):
    _patch_both(monkeypatch)
    monkeypatch.setenv("GAT_REC_COMPILE_CACHE", "off")
    flags = ["--models", "gat", "graph_transformer_optimized", "--epochs", "1", "--lr", "3e-3",
             "--tracking-dir", str(tmp_path / "mlruns"), "--experiment", "probe"]
    jax_module = load_jax_script("pipeline/mlflow_experiment.py")
    monkeypatch.setattr(sys, "argv", ["mlflow_experiment.py", *flags])
    want = _recorded(jax_module.main, monkeypatch)
    got = _recorded(lambda: mlflow_experiment.main([*flags, "--device", "cpu"]), monkeypatch)
    assert [c[0] for c in got] == [c[0] for c in want] == [
        "set_tracking_uri", "set_experiment",
        *(["start_run", "log_params", "log_metrics", "run.__exit__"] * 2)]
    for (name, args, kwargs), (_, w_args, w_kwargs) in zip(got, want):
        if name == "log_metrics":
            assert kwargs == w_kwargs == {"step": 0} and list(args[0]) == list(w_args[0]) == ["train_loss"]
            np.testing.assert_allclose(args[0]["train_loss"], w_args[0]["train_loss"], rtol=LOSS_TOL, atol=LOSS_TOL)
        else:
            assert (args, kwargs) == (w_args, w_kwargs), name
    assert not (tmp_path / "mlruns").exists()  # the local store is not used


def test_without_mlflow_the_local_store_is_used(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "mlflow", None)
    kind, tracker = mlflow_experiment.get_tracker(str(tmp_path), "e")
    assert kind == "local" and isinstance(tracker, mlflow_experiment.LocalTracker)
    args = argparse.Namespace(lr=1e-3, epochs=1, device="cpu")
    result = mlflow_experiment.run_experiment("graphsage", kind, tracker, args)
    run = json.loads(next(tmp_path.glob("e/graphsage-*/run.json")).read_text())
    assert result["finite"] and run["metrics"]["train_loss"][0]["step"] == 0
    assert run["params"]["num_params"] == str(registry.count_params(
        registry.create_model("graphsage", 500, device="cpu", embedding_dim=32, hidden_dim=32)))
