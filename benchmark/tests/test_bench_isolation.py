"""What a run loads and reads, and the shape of its last line.

A run loads no module whose top-level name is ``jax``, ``jaxlib``, ``flax``
or ``gat_recommendation_tpu`` (checked in a fresh interpreter); the
reference imports nothing of the program; nothing of the benchmark opens the
JAX package's bench files; without a card the command prints no result and
exits non-zero; the result line has exactly the contract's keys."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny

ROOT = harness.ROOT
BENCH = ROOT / "benchmark"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}]\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import harness\n"
        "r = tiny.run(tiny.cell('gt_ffn.train_lazy_b512'))\n"
        "print(json.dumps({'correct': r['correct'], 'found': harness.forbidden_modules(),\n"
        "                  'torch': 'gat_recommendation_torch' in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "found": [], "torch": True}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gat_recommendation_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_free", sys)
    assert "gat_recommendation_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_and_the_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    if "reference" in path.relative_to(BENCH).parts:
        assert "gat_recommendation_torch" not in tops


@pytest.mark.parametrize("path", [p for p in SOURCES if "tests" not in p.relative_to(BENCH).parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_opens_the_jax_packages_bench_files(path):
    tree = ast.parse(path.read_text())
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                  and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            assert not any(s in node.value for s in ("BENCH_", "MULTICHIP_", "bench.py")), node.value


def test_without_a_card_no_result_and_a_nonzero_exit(tmp_path):
    for where in (ROOT, tmp_path):
        if where == tmp_path:  # a checkout of BENCHMARK.json and the benchmark's files alone
            shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gt_ffn.train_lazy_b512",
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, timeout=300, cwd=where, env={"PATH": "/usr/bin:/bin"})
        assert out.returncode != 0 and out.stdout.strip() == "", (where, out.stdout, out.stderr[-2000:])


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contracts_keys(trace):
    result = tiny.run(tiny.cell("gt_opt.eval_b512"), trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checked"]
    assert sorted(result) == sorted(keys) and list(result)[-1] == "checked"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checked"]) == {"score_gap", "malformed"}
    assert all(set(v) == {"value", "limit"} for v in result["checked"].values())
    json.dumps(result)
    if not trace:
        assert set(result["metrics"]) == {"eval_sessions_per_s", "setup_s"}
        assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
