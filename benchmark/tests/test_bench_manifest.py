"""BENCHMARK.json against the contract, every part of a cell found by name,
and a configuration, a traffic mix and a per-layer metric added as new
files, with no edit to an existing one."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_the_contract_keys(group, keys):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    for e in MANIFEST[group]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_and_cells_hold_together():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
    for name, w in cells.items():
        assert w["chips"] == 1 and (w["config"], w["traffic"]) in {(w["config"], w["traffic"])}
        c = harness.Cell(MANIFEST, name)
        assert "setup_s" in [m["name"] for m in c.end_to_end] and len(c.end_to_end) >= 2
        assert c.per_layer, name
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(name):
    c = harness.Cell(MANIFEST, name)
    assert c.entry.exists()
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    for path in c.metric_files.values():
        assert path.exists() and callable(harness.load_module(path).read)
    conf = {x["name"]: x for x in MANIFEST["configs"]}[MANIFEST["workloads"][[w["name"] for w in MANIFEST[
        "workloads"]].index(name)]["config"]]
    assert (ROOT / conf["file"]).parent == ROOT / "benchmark" / "configs"


def test_a_new_config_traffic_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a metric and a
    cell as new files and entries, and run the new cell on the CPU."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    config = json.loads((ROOT / "benchmark/configs/gt_opt.json").read_text())
    (root / "benchmark/configs/gt_narrow.json").write_text(json.dumps(dict(config, num_heads=1)))
    traffic = json.loads((ROOT / "benchmark/traffic/train_lazy_b512.json").read_text())
    (root / "benchmark/traffic/train_lazy_b256.json").write_text(json.dumps(dict(traffic, batch_size=256)))
    (root / "benchmark/metrics/steps_seen.train.py").write_text(
        "def read(obs):\n    return float(len(obs['batches']))\n")
    (root / "benchmark/limits/gt_narrow.train_lazy_b256.json").write_text(
        (ROOT / "benchmark/limits/gt_ffn.train_lazy_b512.json").read_text())
    manifest["configs"].append({"name": "gt_narrow", "source": "test", "file": "benchmark/configs/gt_narrow.json",
                                "reduced": ["num_heads"], "why": "test"})
    manifest["workloads"].append({"name": "gt_narrow.train_lazy_b256", "config": "gt_narrow",
                                  "traffic": "train_lazy_b256", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_sessions_per_s":
            m["workloads"].append("gt_narrow.train_lazy_b256")
    manifest["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "test", "moves": "train_sessions_per_s",
                                  "workloads": ["gt_narrow.train_lazy_b256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    c = tiny.cell("gt_narrow.train_lazy_b256", root=root)
    assert c.config["num_heads"] == 1 and c.traffic["entry"] == "train"
    assert "steps_seen.train" in c.metric_files
    result = tiny.run(c, trace=True)
    assert result["correct"] and result["metrics"]["steps_seen.train"]["value"] > 0
