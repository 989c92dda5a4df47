"""Shared set-up of the tests of the port's Quickstart entry points.

A small structured corpus made by the port's data stages (byte-equal to
the JAX scripts', ``test_torch_data_pipeline.py``); the JAX scripts loaded
from ``scripts/`` with importlib and run in-process; ``jax_train`` runs the
JAX ``train_baseline.py`` and keeps the parameters and state it trained
from, so that the port's run can start from the same weights
(``port_train``). Both packages assemble batches with their numpy engine
(the C++ engines draw other negatives than numpy's, and the JAX one is not
always built).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np

from gat_recommendation_torch import convert
from gat_recommendation_torch.data import batching as port_batching
from gat_recommendation_torch.scripts.data import build_graph, generate_synthetic_data, sessionize, temporal_split
from gat_recommendation_torch.scripts.train import train_baseline
from gat_recommendation_tpu.data import batching as jax_batching

REPO = Path(__file__).resolve().parents[1]
# 400 sessions over 1,200 ids (a 1,536-row table of 32 dims: above the gate's
# 0.1 MB artifact floor), most in the 8-node bucket.
CORPUS = ["--num-sessions", "400", "--num-items", "1200", "--structured", "--successors-per-item", "4",
          "--cross-cluster-successors", "1", "--dirichlet-alpha", "0.1"]
SMALL_MODEL = ["--embedding-dim", "32", "--hidden-dim", "32", "--batch-size", "32", "--dropout", "0",
               "--max-epochs", "2"]


def make_corpus(root: Path) -> Path:
    """processed/ (train/val/test.csv, split_info.json, the graph) under `root`."""
    d = str(root)
    assert generate_synthetic_data.main(["--output-file", f"{d}/raw/events.csv", *CORPUS]) == 0
    assert sessionize.main(["--input-file", f"{d}/raw/events.csv", "--output-file", f"{d}/interim/sessions.csv",
                            "--stats-file", f"{d}/interim/session_stats.json"]) == 0
    assert temporal_split.main(["--input-file", f"{d}/interim/sessions.csv", "--output-dir", f"{d}/processed"]) == 0
    assert build_graph.main(["--input-file", f"{d}/processed/train.csv",
                             "--output-file", f"{d}/processed/graph_edges.csv",
                             "--stats-file", f"{d}/processed/graph_stats.json"]) == 0
    return root / "processed"


def data_flags(processed: Path) -> list[str]:
    return ["--train-sessions", str(processed / "train.csv"), "--val-sessions", str(processed / "val.csv"),
            "--graph-edges", str(processed / "graph_edges.csv")]


def load_jax_script(rel: str):
    """A script of ``scripts/`` as a module (its directory on sys.path, as
    when it runs, for the gate's import of evaluate_local)."""
    path = REPO / "scripts" / rel
    if str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location(f"_jax_script_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def numpy_engines(monkeypatch) -> None:
    """Both packages' "auto" batching engine resolves to numpy."""
    monkeypatch.setattr(jax_batching, "_resolve_engine", lambda engine: "numpy")
    monkeypatch.setattr(port_batching, "_resolve_engine", lambda engine: "numpy")


def jax_train(argv: list[str], monkeypatch) -> dict:
    """Run the JAX train_baseline.main() on `argv`; return the model's name,
    config, and the parameters and state (numpy copies) it trained from."""
    module = load_jax_script("train/train_baseline.py")
    kept: dict = {}
    train = module.Trainer.train

    def keep_and_train(self, params=None, state=None, opt_state=None, resume=False):
        copy = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)  # noqa: E731
        kept.update(name=self.model.name, config=dataclasses.asdict(self.model.config),
                    params=copy(params), state=copy(state))
        return train(self, params, state, opt_state, resume)

    monkeypatch.setattr(module.Trainer, "train", keep_and_train)
    monkeypatch.setenv("GAT_REC_COMPILE_CACHE", "off")
    monkeypatch.setattr(sys, "argv", ["train_baseline.py", *argv])
    module.main()
    return kept


def port_train(argv: list[str], start: dict):
    """The port's train_baseline on `argv` (on the CPU) from the weights in
    `start` (``jax_train``'s): build, draw, overwrite with the converted
    weights, run. Returns the Trainer."""
    args = train_baseline.parse_args([*argv, "--device", "cpu"])
    model, trainer, _ = train_baseline.build(args)
    trainer.init_state()
    weights, buffers = convert.from_jax_params(start["params"], start["state"], start["config"], start["name"])
    model.load_state_dict({**weights, **buffers})
    train_baseline.run(args, trainer)
    return trainer


def history(out_dir: Path, model: str = "graph_transformer_optimized") -> dict:
    return json.loads((out_dir / model / "history.json").read_text())
