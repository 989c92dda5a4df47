"""The port's study and tool scripts against the repo's JAX scripts, on the CPU.

The JAX scripts are loaded from ``scripts/`` and run in-process
(``tests/quickstart_torch.py``). Tolerances:

- ``load_best_hits``, ``summarize_refscale``'s stdout, the YooChoose
  ``events.csv`` and every flag's default: EQUAL (bytes and digits; the
  paired bootstrap draws the JAX script's ``default_rng(0)`` stream).
- ``corpus_discrimination`` and ``run_ablations``: both scripts train from
  the same weights (the JAX run's, through ``convert.from_jax_params``) with
  dropout 0 in both packages, a patch of this file and no flag, and both
  packages' numpy batching engines. The popularity baselines, the epochs run
  and the best epochs are EQUAL, and so are the hit vectors' intervals; the
  recall and NDCG values within METRIC_TOL (float32 on both sides, summation
  orders differ; a flipped hit would move a metric by a whole session). The
  discrimination probe trains all four families. GAT's conv bias and
  GraphSAGE's ``lin_l`` bias feed a BatchNorm at once, so their gradient is
  rounding noise, which AdamW turns into steps of about lr whose signs differ
  between the packages (ROADMAP.md, C3). So the probe holds those biases as
  ``tests/test_torch_chain.py`` does, in both packages: a stopped gradient in
  JAX, a zeroed gradient in the port (``_held_biases``); weight decay still
  applies to them in both.
- The YooChoose converter: the JAX script floor-divides pandas' datetime
  integers by 10^6, which are nanoseconds where pandas parses these strings
  to nanoseconds (pandas 2) and microseconds under pandas 3, where the same
  expression gives seconds. The comparison runs the JAX script with pandas'
  parse returned in nanoseconds (the unit its arithmetic assumes), and the
  port's milliseconds are checked against the clock times directly.
- The study shell scripts run with a ``python3`` stub first on ``PATH`` that
  records each command: every command names a module of the port whose
  parser takes its flags (the corpus sweep's inline summary, a script read
  from standard input, reads ``results.json`` and imports only json and sys).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from quickstart_torch import REPO, data_flags, load_jax_script, make_corpus, numpy_engines

from gat_recommendation_torch import convert
from gat_recommendation_torch.scripts import bench_attention
from gat_recommendation_torch.scripts.data import convert_yoochoose
from gat_recommendation_torch.scripts.pipeline import corpus_discrimination, summarize_refscale, validate_sr_onchip
from gat_recommendation_torch.scripts.train import run_ablations
from gat_recommendation_torch.train import hits_io as port_hits
from gat_recommendation_tpu import models as jax_models
from gat_recommendation_tpu.train import hits_io as jax_hits
from gat_recommendation_tpu.train import trainer as jax_trainer
from gat_recommendation_torch.train import trainer as port_trainer

torch.set_num_threads(1)

METRIC_TOL = 1e-6
STUDIES = sorted({str(p.parent.parent.relative_to(REPO)) for p in (REPO / "outputs").rglob("*/history.json")})
SHELL_STUDIES = ("run_refscale_study.sh", "run_corpus_sweep.sh", "run_lr_study.sh")


# -- load_best_hits -----------------------------------------------------------


def test_load_best_hits_reads_both_file_forms_as_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 2, 37), None, rng.integers(0, 2, 41)]
    packed = tmp_path / "packed"
    packed.mkdir()
    jax_hits.save_hits(packed / "hits_k10.npz", rows)
    (packed / "history.json").write_text(json.dumps({"val_hits@10": [[1, 1, 1]]}))  # the sidecar wins
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    (legacy / "history.json").write_text(json.dumps({"val_hits@10": [r.tolist() for r in rows if r is not None],
                                                     "val_hits@20": [[0, 1]]}))
    empty = tmp_path / "empty"
    empty.mkdir()
    for d in (packed, legacy, empty):
        for epoch in range(4):
            for k in (10, 20):
                got, want = port_hits.load_best_hits(d, epoch, k), jax_hits.load_best_hits(d, epoch, k)
                assert (got is None) == (want is None), (d.name, epoch, k)
                if want is not None:
                    assert got.dtype == want.dtype == np.int8 and np.array_equal(got, want)
    assert port_hits.load_best_hits(packed, 2) is not None and port_hits.load_best_hits(packed, 1) is None


# -- summarize_refscale ---------------------------------------------------------


def _jax_summary(study: str, monkeypatch) -> str:
    module = load_jax_script("pipeline/summarize_refscale.py")
    monkeypatch.setattr(sys, "argv", ["summarize_refscale.py", study])
    out = io.StringIO()
    with redirect_stdout(out):
        module.main()
    return out.getvalue()


@pytest.mark.parametrize("study", STUDIES)
def test_summarize_refscale_prints_what_the_jax_script_prints(study, monkeypatch):
    monkeypatch.chdir(REPO)
    want = _jax_summary(study, monkeypatch)
    out = io.StringIO()
    with redirect_stdout(out):
        summarize_refscale.main([study])
    assert out.getvalue() == want
    assert want.startswith("| Model |")


def test_the_committed_studies_include_paired_margins():
    assert len(STUDIES) >= 20
    with_hits = [s for s in STUDIES if len(list((REPO / s).glob("*/hits_k10.npz"))) >= 2]
    assert "outputs/refscale_v3" in with_hits and len(with_hits) >= 5


# -- the flags ---------------------------------------------------------------


class _Parsed(Exception):
    pass


_PARSE = argparse.ArgumentParser.parse_args


def _parsed(main, monkeypatch, argv: list[str], *args) -> dict:
    """The namespace `main` parses from `argv`, without running it."""
    seen = {}

    def capture(self, _argv=None, namespace=None):
        seen.update(vars(_PARSE(self, argv, namespace)))
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main(*args)
    return seen


@pytest.mark.parametrize("script,port,required,extra", [
    ("pipeline/summarize_refscale.py", summarize_refscale, ["outputs/refscale_v3"], set()),
    ("pipeline/corpus_discrimination.py", corpus_discrimination, [], {"device"}),
    ("train/run_ablations.py", run_ablations, [], {"device"}),
    ("data/01b_convert_yoochoose.py", convert_yoochoose, ["--clicks-file", "c.dat"], set()),
    ("bench_attention.py", bench_attention, [], set()),
])
def test_every_flag_has_the_jax_scripts_default(script, port, required, extra, monkeypatch):
    pytest.importorskip("optax")
    module = load_jax_script(script)
    want = _parsed(module.main, monkeypatch, required)
    got = _parsed(port.main, monkeypatch, required, [])
    assert set(got) == set(want) | extra
    assert {k: got[k] for k in want} == want


def test_card_only_tools_raise_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_sr_onchip.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_attention.main(["--buckets", "8", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        corpus_discrimination.main(["--num-sessions", "10"])  # the trainers default to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ablations.main([])


# -- the trainers ----------------------------------------------------------------


def _held_biases(create, package):
    """`create` with dropout 0 whose models take no gradient in the biases
    that feed a BatchNorm at once: GAT's conv bias, GraphSAGE's ``lin_l``
    bias. JAX: the model's apply stops their gradient; the port: a hook
    zeroes it. The optimizer then sees a zero gradient in both."""
    def build(name, num_items, **kwargs):
        model = create(name, num_items, **{**kwargs, "dropout": 0.0})
        if name not in ("gat", "graphsage"):
            return model
        if package == "port":
            for conv in model.convs:
                (conv.bias if name == "gat" else conv.lin_l.bias).register_hook(torch.zeros_like)
            return model

        def held(conv):
            if name == "gat":
                return {**conv, "bias": jax.lax.stop_gradient(conv["bias"])}
            return {**conv, "lin_l": {**conv["lin_l"], "b": jax.lax.stop_gradient(conv["lin_l"]["b"])}}

        def apply(params, state, batch, cfg, _apply=model.apply, **kw):
            return _apply({**params, "convs": [held(c) for c in params["convs"]]}, state, batch, cfg, **kw)

        return dataclasses.replace(model, apply=apply)

    return build


def _keep_jax_starts(monkeypatch) -> list:
    """Patch the JAX Trainer to keep the parameters and state each run starts from."""
    starts: list = []
    train = jax_trainer.Trainer.train

    def keep(self, params=None, state=None, opt_state=None, resume=False):
        copy = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)  # noqa: E731
        starts.append(dict(name=self.model.name, config=dataclasses.asdict(self.model.config),
                           params=copy(params), state=copy(state)))
        return train(self, params, state, opt_state, resume)

    monkeypatch.setattr(jax_trainer.Trainer, "train", keep)
    monkeypatch.setenv("GAT_REC_COMPILE_CACHE", "off")
    return starts


def _start_port_from(starts: list, monkeypatch) -> list:
    """Patch the port's Trainer to start each run from the next of `starts`."""
    pending, seen = list(starts), []
    train = port_trainer.Trainer.train

    def load_and_train(self, *args, **kwargs):
        start = pending.pop(0)
        assert start["name"] == self.model.name
        weights, buffers = convert.from_jax_params(start["params"], start["state"], start["config"], start["name"])
        self.model.load_state_dict({**weights, **buffers})
        seen.append(dataclasses.asdict(self.model.config))
        return train(self, *args, **kwargs)

    monkeypatch.setattr(port_trainer.Trainer, "train", load_and_train)
    return seen


PROBE = ["--num-sessions", "260", "--num-items", "400", "--num-active", "120", "--num-clusters", "4",
         "--max-epochs", "2", "--patience", "2", "--embedding-dim", "16", "--batch-size", "32",
         "--models", "graph_transformer_optimized", "graph_transformer", "gat", "graphsage"]


def test_corpus_discrimination_matches_the_jax_script(tmp_path, monkeypatch):
    numpy_engines(monkeypatch)
    starts = _keep_jax_starts(monkeypatch)
    monkeypatch.setattr(jax_models, "create_model", _held_biases(jax_models.create_model, "jax"))
    monkeypatch.setattr(sys, "argv", ["corpus_discrimination.py", *PROBE, "--output-dir", str(tmp_path / "jax")])
    load_jax_script("pipeline/corpus_discrimination.py").main()
    want = json.loads((tmp_path / "jax" / "results.json").read_text())

    configs = _start_port_from(starts, monkeypatch)
    monkeypatch.setattr(corpus_discrimination, "create_model",
                        _held_biases(corpus_discrimination.create_model, "port"))
    got = corpus_discrimination.main([*PROBE, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert json.loads((tmp_path / "port" / "results.json").read_text()) == got
    assert [c["dropout"] for c in configs] == [0.0] * 4 and [s["config"] for s in starts] == configs

    assert {k: v for k, v in got["config"].items() if k != "device"} == {
        k: v for k, v in want["config"].items() if k != "output_dir"} | {"output_dir": str(tmp_path / "port")}
    assert got["baselines"] == want["baselines"]
    assert list(got["models"]) == list(want["models"]) == PROBE[-4:]
    for name, row in want["models"].items():
        mine = got["models"][name]
        assert (mine["best_epoch"], mine["epochs_run"]) == (row["best_epoch"], row["epochs_run"]), name
        assert mine["ci95"] == row["ci95"], name
        np.testing.assert_allclose(mine["best_recall@10"], row["best_recall@10"], atol=METRIC_TOL, err_msg=name)
        np.testing.assert_allclose(mine["trajectory_recall@10"], row["trajectory_recall@10"], atol=METRIC_TOL)
    assert got["order"] == want["order"] and got["pairwise_margins"] == want["pairwise_margins"]
    assert got["unresolved_pairs"] == want["unresolved_pairs"]


def test_the_popularity_baseline_keeps_pandas_order_inside_tied_counts():
    """Rank 10 and rank 20 fall inside a run of 71 tied counts: the items that
    make the top 10 and 20 are those of pandas' unstable sort. The validation
    targets are the tied items a stable sort would pick (the smallest ids),
    so the recall tells the two orders apart."""
    rng = np.random.default_rng(0)
    counts = np.r_[[50] * 6, [20] * 71, rng.integers(1, 19, 30)]
    items = rng.permutation(np.arange(1, len(counts) + 1))
    train = {"itemid": rng.permutation(np.repeat(items, counts))}
    size = pd.DataFrame(train).groupby("itemid").size()
    pop = size.sort_values(ascending=False)
    tied = np.sort(items[6:77])
    stable_top = set(size.sort_values(ascending=False, kind="stable").index[:20])
    assert stable_top != set(pop.index[:20]) and set(tied[:14]) <= stable_top
    targets = np.r_[tied[:14], items[:6]]
    val = {"session_id": np.repeat(np.arange(len(targets)).astype(str), 2),
           "timestamp": np.tile([2, 1], len(targets)),  # the last event in time comes first in the file
           "itemid": np.c_[targets, np.zeros(len(targets), np.int64)].reshape(-1)}
    vdf = pd.DataFrame(val)
    last = vdf.sort_values(["session_id", "timestamp"]).groupby("session_id")["itemid"].last()
    want = {f"popularity_recall@{k}": float(np.mean([t in set(pop.index[:k]) for t in last])) for k in (10, 20)}
    assert want["popularity_recall@20"] < 1.0  # pandas' order keeps some of the smallest tied ids out
    assert corpus_discrimination.popularity_baselines(train, val) == want


ABLATIONS = {
    "base": {"model": "graph_transformer_optimized", "embedding_dim": 16, "hidden_dim": 16, "num_layers": 2,
             "num_heads": 2, "dropout": 0.0, "laplacian_k": 8, "loss_type": "dual"},
    "ablations": {"loss_bpr": {"loss_type": "bpr"}, "with_ffn": {"use_ffn": True, "ffn_expansion": 2}},
}


def test_run_ablations_matches_the_jax_script(tmp_path, monkeypatch):
    pytest.importorskip("optax")
    yaml = pytest.importorskip("yaml")
    processed = make_corpus(tmp_path / "corpus")
    config = tmp_path / "ablations.yaml"
    config.write_text(yaml.safe_dump(ABLATIONS, sort_keys=False))
    argv = ["--config", str(config), *data_flags(processed), "--max-epochs", "2", "--batch-size", "32"]
    numpy_engines(monkeypatch)
    monkeypatch.chdir(tmp_path)  # both scripts write outputs/ablations/<name> where they run
    starts = _keep_jax_starts(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["run_ablations.py", *argv, "--results-file", str(tmp_path / "jax.json")])
    load_jax_script("train/run_ablations.py").main()
    want = json.loads((tmp_path / "jax.json").read_text())

    _start_port_from(starts, monkeypatch)
    got = run_ablations.main([*argv, "--results-file", str(tmp_path / "port.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    assert list(got) == list(want) == list(ABLATIONS["ablations"])
    for name, row in want.items():
        assert got[name]["config"] == row["config"], name
        metrics = {k for k in row if k not in ("seconds", "config")}
        assert metrics == {k for k in got[name] if k not in ("seconds", "config")} and "recall@10" in metrics
        for k in sorted(metrics):
            np.testing.assert_allclose(got[name][k], row[k], atol=METRIC_TOL, err_msg=f"{name} {k}")
        assert (tmp_path / "outputs" / "ablations" / name / "history.json").exists()


# -- YooChoose ---------------------------------------------------------------


def _yoochoose_files(root: Path) -> tuple[Path, Path]:
    """Clicks and buys in YooChoose's format: session,ISO time,item,category
    (numbers or "S") and session,ISO time,item,price,quantity; times in
    milliseconds with Z, many equal times (the sort must be stable), one
    before 1970 with sub-millisecond digits (the floor)."""
    rng = np.random.default_rng(11)
    base = np.datetime64("2014-04-01T00:00:00.000")
    clicks, buys = root / "yoochoose-clicks.dat", root / "yoochoose-buys.dat"
    lines = []
    for i in range(300):
        t = base if i % 13 == 0 else base + np.timedelta64(int(rng.integers(0, 3 * 86_400_000)), "ms")
        cat = "S" if i % 5 == 0 else str(int(rng.integers(0, 12)))
        lines.append(f"{int(rng.integers(1, 40))},{t}Z,{int(rng.integers(214_500_000, 214_600_000))},{cat}")
    lines.append("7,1969-12-31T23:59:59.9995Z,214536500,0")
    clicks.write_text("\n".join(lines) + "\n")
    buys.write_text("".join(
        f"{int(rng.integers(1, 40))},{base if i % 4 == 0 else base + np.timedelta64(int(rng.integers(0, 86_400_000)), 'ms')}Z,"
        f"{int(rng.integers(214_500_000, 214_600_000))},{int(rng.integers(0, 5000))},{int(rng.integers(1, 4))}\n"
        for i in range(60)))
    return clicks, buys


@pytest.mark.parametrize("with_buys", [True, False])
def test_convert_yoochoose_writes_the_jax_scripts_bytes(tmp_path, monkeypatch, with_buys):
    clicks, buys = _yoochoose_files(tmp_path)
    flags = ["--clicks-file", str(clicks)] + (["--buys-file", str(buys)] if with_buys else [])
    module = load_jax_script("data/01b_convert_yoochoose.py")
    parse = pd.to_datetime
    monkeypatch.setattr(module.pd, "to_datetime", lambda *a, **k: parse(*a, **k).dt.as_unit("ns"))
    monkeypatch.setattr(sys, "argv", ["01b_convert_yoochoose.py", *flags, "--output-file", str(tmp_path / "jax.csv")])
    module.main()
    assert convert_yoochoose.main([*flags, "--output-file", str(tmp_path / "port.csv")]) == 0
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    rows = pd.read_csv(tmp_path / "port.csv")
    assert len(rows) == 301 + 60 * with_buys and rows["timestamp"].is_monotonic_increasing
    assert rows["timestamp"].iloc[0] == -1  # 1969-12-31T23:59:59.9995 floors to -1 ms
    assert int(rows.loc[rows["itemid"] == 214536500, "timestamp"].iloc[0]) == -1
    assert (rows["timestamp"].iloc[1:] >= 1_396_310_400_000).all()  # milliseconds since 1970
    bought = rows["event"] == "transaction"
    assert bought.sum() == 60 * with_buys and rows["transactionid"].isna().sum() == 301
    assert (rows.loc[bought, "transactionid"].astype(int).astype(str)
            == rows.loc[bought, "visitorid"].str.removeprefix("yc_")).all()


# -- the study shell scripts ----------------------------------------------------------

STUB = """#!/bin/sh
{ printf '%s\\0' "$@"; printf '\\n'; } >> "$STUB_LOG"
if [ "$1" = "-" ]; then cat > "$STUB_LOG.stdin"; fi
exit 0
"""


def _recorded(script: str, tmp_path: Path) -> tuple[list[list[str]], str]:
    """Run a copy of `script` (in the package's layout under tmp_path, so that
    it runs from tmp_path) with the stub first on PATH; the commands it ran."""
    root = tmp_path / "tree"
    copy = root / "gat_recommendation_torch" / "scripts" / "pipeline" / script
    copy.parent.mkdir(parents=True)
    copy.write_text((REPO / "gat_recommendation_torch" / "scripts" / "pipeline" / script).read_text())
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir()
    (stub_dir / "python3").write_text(STUB)
    (stub_dir / "python3").chmod(0o755)
    log = tmp_path / "commands.log"
    env = {**os.environ, "PATH": f"{stub_dir}:{os.environ['PATH']}", "STUB_LOG": str(log)}
    out = subprocess.run(["bash", str(copy)], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    commands = [line.split("\0")[:-1] for line in log.read_text().splitlines()] if log.exists() else []
    stdin = Path(f"{log}.stdin")
    return commands, stdin.read_text() if stdin.exists() else ""


@pytest.mark.parametrize("script", SHELL_STUDIES)
def test_each_study_script_calls_only_the_ports_entry_points(script, tmp_path, monkeypatch):
    import importlib

    commands, stdin_script = _recorded(script, tmp_path)
    modules = [c for c in commands if c[0] == "-m"]
    assert modules and all(c[1].startswith("gat_recommendation_torch.") for c in modules)
    for _, name, *flags in modules:
        module = importlib.import_module(name)
        parsed = _parsed(module.main, monkeypatch, flags, flags)
        assert parsed, name
        if name.endswith((".train_baseline", ".evaluate_local", ".model_quality_gate", ".corpus_discrimination")):
            assert parsed["device"] is None, name  # the trainers and the evaluation run on the card
    others = [c for c in commands if c[0] != "-m"]
    if script == "run_corpus_sweep.sh":
        assert len(modules) == len(others) == 7 and all(c[0] == "-" for c in others)
        assert "import json, sys\n" in stdin_script and "gat_recommendation_tpu" not in stdin_script
    else:
        assert not others
    text = (REPO / "gat_recommendation_torch" / "scripts" / "pipeline" / script).read_text()
    assert "python scripts/" not in text and "python3 scripts/" not in text and "JAX_PLATFORMS" not in text


def test_the_refscale_study_runs_every_stage(tmp_path):
    commands, _ = _recorded("run_refscale_study.sh", tmp_path)
    names = [c[1].rsplit(".", 1)[-1] for c in commands]
    assert names == ["generate_synthetic_data", "sessionize", "temporal_split", "build_graph",
                     *["train_baseline"] * 5, "evaluate_local", "model_quality_gate", "latency_bench"]
    assert commands[-1][2:4] == ["--device", "cpu"]  # the serving latency on the CPU, as in the JAX script
    assert all("--record-hits" in c for c in commands[4:8]) and "--bf16-moments" in commands[8]
