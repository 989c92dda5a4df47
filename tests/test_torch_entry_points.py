"""The port's entry points: flags, one-GPU guards, GCS upload, resume, the
order of drawing and encodings, and run_full_pipeline against the JAX script.

Every flag of each JAX script exists in the port's module with the same
default (both parsed with an empty argv; the port adds ``--device``, and
``regen_refscale`` ``--data-dir``). The pipeline's results hold the JAX
script's keys and verdicts on the same subset (equality, no tolerance), and
its wiring the JAX script's: the same subset rows, each model's config, the
step seeds, and, from the JAX script's initial weights with dropout 0, each
step's loss within PIPELINE_LOSS_RTOL.
"""

import argparse
import dataclasses
import json
import logging
import sys

import numpy as np
import pytest
import torch
from quickstart_torch import SMALL_MODEL, data_flags, history, load_jax_script, make_corpus, numpy_engines

import gat_recommendation_tpu.models as jax_models
import gat_recommendation_tpu.train.trainer as jax_trainer
from gat_recommendation_torch import convert

from gat_recommendation_torch.models.laplacian_pe import compute_laplacian_pe
from gat_recommendation_torch.scripts import evaluate_local
from gat_recommendation_torch.scripts.data import (
    build_graph,
    generate_synthetic_data,
    regen_refscale,
    remap_ids,
    sessionize,
    temporal_split,
)
from gat_recommendation_torch.scripts.pipeline import model_quality_gate, run_full_pipeline
from gat_recommendation_torch.scripts.train import train_baseline

torch.set_num_threads(1)

PIPELINE_LOSS_RTOL = 1e-5  # float32 on both sides, summation orders differ

CLIS = {"train/train_baseline.py": train_baseline, "evaluate_local.py": evaluate_local,
        "pipeline/model_quality_gate.py": model_quality_gate, "pipeline/run_full_pipeline.py": run_full_pipeline}
STAGES = {"data/00_generate_synthetic_data.py": generate_synthetic_data, "data/02_sessionize.py": sessionize,
          "data/03_temporal_split.py": temporal_split, "data/04_build_graph.py": build_graph,
          "data/05_remap_ids.py": remap_ids, "data/regen_refscale.py": regen_refscale}


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


class _Parsed(Exception):
    pass


_PARSE = argparse.ArgumentParser.parse_args


def _defaults(main, monkeypatch, *args) -> dict:
    """The namespace `main` parses from an empty command line."""
    seen = {}

    def capture(self, argv=None, namespace=None):
        seen.update(vars(_PARSE(self, [], namespace)))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main(*args)
    return seen


@pytest.mark.parametrize("script", [*CLIS, *STAGES])
def test_every_flag_has_the_jax_scripts_default(script, monkeypatch):
    port = {**CLIS, **STAGES}[script]
    module = load_jax_script(script)
    monkeypatch.setattr(sys, "argv", [script])
    jax_main = module.parse_args if script == "train/train_baseline.py" else module.main
    want = _defaults(jax_main, monkeypatch)
    got = _defaults(port.main, monkeypatch, [])
    extra = {"device"} if script in CLIS else {"data_dir"} if script.endswith("regen_refscale.py") else set()
    assert set(got) == set(want) | extra
    assert {k: got[k] for k in want} == want
    assert len(want) >= 2


@pytest.mark.parametrize("argv,env,gpus,match", [
    (["--mesh"], {}, 0, "A8"),
    (["--n-model", "2", "--no-mesh"], {}, 0, "A8"),
    ([], {"WORLD_SIZE": "2"}, 0, "multi-process"),
    ([], {}, 2, "--no-mesh"),
])
def test_mesh_and_multi_process_launches_raise(argv, env, gpus, match, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if gpus:  # the card count is all the guard reads; nothing is allocated
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    device = [] if gpus else ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match=match):
        train_baseline.main([*argv, *device])


class _Client:
    """An injected storage client: bucket(name).blob(path).upload_from_filename."""

    def __init__(self):
        self.uploaded: dict = {}

    def bucket(self, name):
        client = self

        class Blob:
            def __init__(self, path):
                self.path = path

            def upload_from_filename(self, local):
                client.uploaded[self.path] = open(local, "rb").read()

        return type("Bucket", (), {"blob": lambda _, path: Blob(path)})()


def test_gcs_upload_walks_the_output_dir(tmp_path):
    out = tmp_path / "graph_transformer_optimized"
    (out / "checkpoint_best").mkdir(parents=True)
    (out / "checkpoint_best" / "meta.json").write_text("{}")
    (out / "checkpoint_best" / "tensors.pt").write_bytes(b"\x00\x01")
    (out / "history.json").write_text('{"train_loss": []}')
    client = _Client()
    assert train_baseline.maybe_gcs_upload("b", out, logging.getLogger("t"), client=client) == 3
    assert set(client.uploaded) == {"graph_transformer_optimized/checkpoint_best/meta.json",
                                    "graph_transformer_optimized/checkpoint_best/tensors.pt",
                                    "graph_transformer_optimized/history.json"}
    assert client.uploaded["graph_transformer_optimized/checkpoint_best/tensors.pt"] == b"\x00\x01"
    assert train_baseline.maybe_gcs_upload(None, out, logging.getLogger("t")) == 0


def test_resume_continues_the_epoch_count(processed, tmp_path):
    argv = [*data_flags(processed), *SMALL_MODEL, "--device", "cpu", "--output-dir", str(tmp_path), "--chain", "4"]
    assert train_baseline.main([*argv, "--max-epochs", "1"]) == 0
    first = history(tmp_path)
    assert train_baseline.main([*argv, "--max-epochs", "3", "--resume"]) == 0
    resumed = history(tmp_path)
    assert len(resumed["train_loss"]) == len(resumed["val_metrics"]) == 3
    assert resumed["train_loss"][0] == first["train_loss"][0]
    assert resumed["val_metrics"][0] == first["val_metrics"][0]
    meta = json.loads((tmp_path / "graph_transformer_optimized" / "checkpoint_latest" / "meta.json").read_text())
    assert meta["epoch"] == 2


def test_parameters_are_drawn_before_the_encodings(processed):
    """initialize: init_state's draw, then the encodings of the full graph,
    which the draw would not leave in place the other way round."""
    args = train_baseline.parse_args([*data_flags(processed), *SMALL_MODEL, "--device", "cpu"])
    model, trainer, edges = train_baseline.build(args)
    train_baseline.initialize(args, model, trainer, edges)
    pe = compute_laplacian_pe(*edges, model.config.num_items, k=model.config.laplacian_k)
    assert torch.equal(model.cached_pe[: len(pe)], torch.from_numpy(pe))
    assert model.cached_pe.abs().sum() > 0
    drawn = {k: v.clone() for k, v in model.named_parameters()}
    trainer.init_state()  # the same seed draws the same parameters
    assert all(torch.equal(drawn[k], v) for k, v in model.named_parameters())


def test_run_full_pipeline_matches_the_jax_script(processed, tmp_path, monkeypatch):
    argv = ["--train-sessions", str(processed / "train.csv"), "--graph-edges", str(processed / "graph_edges.csv"),
            "--num-sessions", "30", "--num-epochs", "2"]
    module = load_jax_script("pipeline/run_full_pipeline.py")
    monkeypatch.setattr(sys, "argv", ["run_full_pipeline.py", *argv, "--results-file", str(tmp_path / "jax.json")])
    with pytest.raises(SystemExit) as jax_exit:
        module.main()
    rc = run_full_pipeline.main([*argv, "--results-file", str(tmp_path / "port.json"), "--device", "cpu"])
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert rc == jax_exit.value.code == 0
    assert list(got) == list(want) and got["num_sessions"] == want["num_sessions"] == 30
    assert list(got["models"]) == list(want["models"])
    for name, row in want["models"].items():
        assert list(got["models"][name]) == list(row) and got["models"][name]["pass"] == row["pass"], name
    # The defaults (100 sessions, 3 epochs) pass too.
    assert run_full_pipeline.main([*argv[:4], "--results-file", str(tmp_path / "d.json"), "--device", "cpu"]) == 0
    assert all(np.isfinite(r["last_loss"]) for r in json.loads((tmp_path / "d.json").read_text())["models"].values())


def test_run_full_pipeline_trains_what_the_jax_script_trains(processed, tmp_path, monkeypatch):
    """The JAX script and the port on one subset, dropout 0 in both: the
    port's subset is pandas' (the first session ids in file order), each
    model has the JAX model's config (widths 64, laplacian_k 8) and, started
    from the JAX script's first parameters and state through convert.py,
    takes the same step seeds and gives the same loss at every step."""
    jax = pytest.importorskip("jax")
    pd = pytest.importorskip("pandas")
    numpy_engines(monkeypatch)
    path = processed / "train.csv"
    argv = ["--train-sessions", str(path), "--graph-edges", str(processed / "graph_edges.csv"),
            "--num-sessions", "30", "--num-epochs", "2"]

    sessions = pd.read_csv(path)
    want = sessions[sessions["session_id"].isin(sessions["session_id"].drop_duplicates().head(30))]
    got = run_full_pipeline.session_subset(str(path), 30)
    assert list(got) == list(want.columns)
    for col in want.columns:
        np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)

    def no_dropout(create):
        def build(name, num_items, **kwargs):
            return create(name, num_items, **{**kwargs, "dropout": 0.0})
        return build

    jax_runs: dict = {}
    jax_step = jax_trainer.make_train_step

    def keep_jax_steps(model, loss_fn, optimizer):
        step = jax_step(model, loss_fn, optimizer)
        run = jax_runs.setdefault(model.name, {"losses": [], "keys": []})

        def kept(params, state, opt_state, batch, key):
            if "params" not in run:
                copy = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)  # noqa: E731
                run.update(config=dataclasses.asdict(model.config), params=copy(params), state=copy(state))
            out = step(params, state, opt_state, batch, key)
            run["keys"].append(np.asarray(jax.random.key_data(key)))
            run["losses"].append(float(out[-1]))
            return out
        return kept

    monkeypatch.setattr(jax_models, "create_model", no_dropout(jax_models.create_model))
    monkeypatch.setattr(jax_trainer, "make_train_step", keep_jax_steps)
    monkeypatch.setattr(sys, "argv", ["run_full_pipeline.py", *argv, "--results-file", str(tmp_path / "jax.json")])
    with pytest.raises(SystemExit) as jax_exit:
        load_jax_script("pipeline/run_full_pipeline.py").main()

    port_runs: dict = {}
    port_step = run_full_pipeline.make_train_step

    def start_from_jax(model, loss_fn, optimizer, opt_state):
        start = jax_runs[model.name]
        weights, buffers = convert.from_jax_params(start["params"], start["state"], start["config"], model.name)
        model.load_state_dict({**weights, **buffers})
        step = port_step(model, loss_fn, optimizer, opt_state)
        run = port_runs.setdefault(model.name, {"config": dataclasses.asdict(model.config), "losses": [],
                                                "seeds": []})

        def kept(batch, seed):
            loss = step(batch, seed=seed)
            run["seeds"].append(seed)
            run["losses"].append(float(loss))
            return loss
        return kept

    monkeypatch.setattr(run_full_pipeline, "create_model", no_dropout(run_full_pipeline.create_model))
    monkeypatch.setattr(run_full_pipeline, "make_train_step", start_from_jax)
    rc = run_full_pipeline.main([*argv, "--results-file", str(tmp_path / "port.json"), "--device", "cpu"])
    assert rc == jax_exit.value.code == 0
    got_results, want_results = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert got_results["num_sessions"] == want_results["num_sessions"] == 30

    assert list(port_runs) == list(jax_runs) == list(want_results["models"])
    for name, want_run in jax_runs.items():
        got_run = port_runs[name]
        config = want_run["config"]
        assert config["embedding_dim"] == config["hidden_dim"] == 64, name
        assert config.get("laplacian_k", 8) == 8 and config["dropout"] == 0.0, name
        assert {k: got_run["config"][k] for k in config} == config, name
        assert len(got_run["seeds"]) == len(want_run["keys"]) > 1, name
        for seed, key in zip(got_run["seeds"], want_run["keys"]):
            np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.key(seed))), key)
        np.testing.assert_allclose(got_run["losses"], want_run["losses"], rtol=PIPELINE_LOSS_RTOL, err_msg=name)
        for key in ("first_loss", "last_loss"):
            np.testing.assert_allclose(got_results["models"][name][key], want_results["models"][name][key],
                                       rtol=PIPELINE_LOSS_RTOL, err_msg=f"{name} {key}")
