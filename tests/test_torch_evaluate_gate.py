"""The port's evaluate_local and quality gate against the JAX scripts, on one
checkpoint in both formats.

The JAX ``train_baseline.py`` trains the small corpus for one epoch
(dropout 0); its ``checkpoint_best`` is carried into the port's format
through ``convert.py``. ``evaluate_checkpoint`` on the two gives metrics
within 1e-9 (float32 forwards, the same ranking); ``evaluate_local.main``
writes the JAX script's keys; the gate's results JSON has the JAX gate's
keys and the same pass or fail in every phase and overall, its metrics
within 1e-9 (latency values excluded: they are times).
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import pytest
import torch
from quickstart_torch import SMALL_MODEL, data_flags, load_jax_script, make_corpus, numpy_engines

from gat_recommendation_torch import convert
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.scripts import evaluate_local
from gat_recommendation_torch.scripts.pipeline import model_quality_gate
from gat_recommendation_torch.train import checkpoint
from gat_recommendation_tpu.data.batching import SessionDataset as JaxSessionDataset
from gat_recommendation_tpu.data.graph import load_edges as jax_load_edges
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.train import checkpoint as jax_checkpoint

torch.set_num_threads(1)

MODEL = "graph_transformer_optimized"
THRESHOLDS = str(Path(__file__).resolve().parents[1] / "configs" / "quality_thresholds.yaml")
# Each case's verdicts: one epoch stays below the repo's metric floors.
VERDICTS = {
    "repo_thresholds": {"artifact": True, "metrics": False, "latency": True},
    "floors_at_zero": {"artifact": True, "metrics": True, "latency": True},
    "skip_metrics": {"artifact": True, "latency": True},
    "missing_checkpoint": {"artifact": False},
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(processed dir, JAX outputs dir, port outputs dir): each holds
    <model>/checkpoint_best of the same weights."""
    root = tmp_path_factory.mktemp("quickstart")
    processed = make_corpus(root / "data")
    with pytest.MonkeyPatch.context() as mp:
        numpy_engines(mp)
        mp.setenv("GAT_REC_COMPILE_CACHE", "off")
        mp.setattr(sys, "argv", ["train_baseline.py", *data_flags(processed), *SMALL_MODEL, "--max-epochs", "1",
                                 "--output-dir", str(root / "jax"), "--no-mesh", "--chain", "1"])
        load_jax_script("train/train_baseline.py").main()
    jax_dir = root / "jax" / MODEL / "checkpoint_best"
    meta = jax_checkpoint.load_meta(jax_dir)
    cfg = dict(meta["model_config"])
    jax_model = jax_create_model(meta["model_name"], cfg.pop("num_items"), **cfg)
    params, state = jax_checkpoint.restore_params_state(jax_dir, *jax_model.init_params(jax.random.key(0)))
    full_cfg = dataclasses.asdict(jax_model.config)
    model = create_model(MODEL, full_cfg["num_items"], device="cpu", **cfg)
    weights, buffers = convert.from_jax_params(params, state, full_cfg, MODEL)
    model.load_state_dict({**weights, **buffers})
    checkpoint.save(root / "port" / MODEL / "checkpoint_best", model, epoch=meta["epoch"],
                    best_val_metric=meta["best_val_metric"], history=meta["history"])
    return processed, root / "jax", root / "port"


def test_evaluate_checkpoint_matches_the_jax_script(checkpoints):
    processed, jax_out, port_out = checkpoints
    module = load_jax_script("evaluate_local.py")
    edges = jax_load_edges(processed / "graph_edges.csv")
    num_items = json.loads((processed / "split_info.json").read_text())["num_items"]
    want = module.evaluate_checkpoint(jax_out / MODEL / "checkpoint_best",
                                      JaxSessionDataset(str(processed / "test.csv"), edges, num_items=num_items),
                                      64, [5, 10, 20])
    got = evaluate_local.evaluate_checkpoint(port_out / MODEL / "checkpoint_best",
                                             evaluate_local.load_test_split(str(processed / "test.csv"),
                                                                            str(processed / "graph_edges.csv")),
                                             64, [5, 10, 20], "cpu")
    assert list(got) == list(want) and got["num_sessions"] == want["num_sessions"] > 0
    assert got["epoch"] == want["epoch"] == 0
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-9), key
    assert want["recall@20"] > 0


def test_evaluate_local_main_writes_the_jax_results(checkpoints, tmp_path, monkeypatch):
    processed, jax_out, port_out = checkpoints
    (port_out / "no_checkpoint").mkdir(exist_ok=True)  # skipped, as the JAX script skips it
    flags = ["--test-sessions", str(processed / "test.csv"), "--graph-edges", str(processed / "graph_edges.csv"),
             "--batch-size", "16"]
    monkeypatch.setattr(sys, "argv", ["evaluate_local.py", *flags, "--outputs-dir", str(jax_out),
                                      "--results-file", str(tmp_path / "jax.json")])
    load_jax_script("evaluate_local.py").main()
    assert evaluate_local.main([*flags, "--outputs-dir", str(port_out), "--results-file", str(tmp_path / "port.json"),
                                "--device", "cpu"]) == 0
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert list(got) == list(want) == [MODEL]
    assert list(got[MODEL]) == list(want[MODEL])
    for key, value in want[MODEL].items():
        assert got[MODEL][key] == pytest.approx(value, abs=1e-9), key


def _verdicts(results: dict) -> dict:
    return {name: not (phase.get("error") or phase.get("failures")) for name, phase in results["phases"].items()}


CASES = {"repo_thresholds": [], "skip_metrics": ["--skip-metrics"], "missing_checkpoint": [],
         "floors_at_zero": ["--min-recall-10", "0", "--min-recall-20", "0", "--min-ndcg-10", "0", "--min-ndcg-20", "0"]}


@pytest.mark.parametrize("case", list(CASES))
def test_quality_gate_matches_the_jax_gate(checkpoints, tmp_path, monkeypatch, case):
    processed, jax_out, port_out = checkpoints
    flags = ["--test-sessions", str(processed / "test.csv"), "--graph-edges", str(processed / "graph_edges.csv"),
             "--thresholds", THRESHOLDS, "--latency-requests", "8", "--batch-size", "32"]
    sub = "no_such_checkpoint" if case == "missing_checkpoint" else "checkpoint_best"
    overrides = CASES[case]
    monkeypatch.setattr(sys, "argv", ["model_quality_gate.py", *flags, *overrides,
                                      "--checkpoint", str(jax_out / MODEL / sub),
                                      "--results-file", str(tmp_path / "jax.json")])
    with pytest.raises(SystemExit) as jax_exit:
        load_jax_script("pipeline/model_quality_gate.py").main()
    rc = model_quality_gate.main([*flags, *overrides, "--checkpoint", str(port_out / MODEL / sub),
                                  "--results-file", str(tmp_path / "port.json"), "--device", "cpu"])
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert rc == jax_exit.value.code
    assert list(got) == list(want) and got["pass"] == want["pass"] == (rc == 0)
    assert list(got["phases"]) == list(want["phases"])
    assert _verdicts(got) == _verdicts(want) == VERDICTS[case]
    for name, phase in want["phases"].items():
        assert list(got["phases"][name]) == list(phase), name
    if "metrics" in want["phases"]:
        for key in ("recall@10", "recall@20", "ndcg@10", "ndcg@20"):
            assert got["phases"]["metrics"][key] == pytest.approx(want["phases"]["metrics"][key], abs=1e-9)
        assert got["phases"]["metrics"]["failures"] == want["phases"]["metrics"]["failures"]
