"""The port's ``export_onnx`` against the repo's ``scripts/pipeline/export_onnx.py``, on the CPU.

The JAX script is loaded from ``scripts/`` and run in-process
(``tests/quickstart_torch.py``). Tolerances:

- ``item_embeddings.npy``: EQUAL, byte for byte, in every mode: the demo
  table (``default_rng(42)``), a custom ``.npy`` (float64 on disk, both cast
  to float32), and in production mode the table of a JAX checkpoint carried
  into a port checkpoint by ``convert.from_jax_params`` (the same weights),
  with the same padded shape (phantom rows included).
- ``model_metadata.json``: the same keys in the same order and EQUAL values,
  but for ``exported_at``, the latencies and ``scorer_validation_max_diff``
  (each script's own check against the numpy oracle, below 1e-4 in both),
  and in production mode ``source`` (each script's own checkpoint path).
- A lazy run's checkpoint exports the materialized table: EQUAL to the
  Trainer's table after its last materialize, which every row's
  ``last_step`` (equal to the step count) confirms.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from quickstart_torch import load_jax_script

from gat_recommendation_torch import convert
from gat_recommendation_torch.data import batching as port_batching
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.models.base import padded_rows
from gat_recommendation_torch.scripts.pipeline import export_onnx
from gat_recommendation_torch.train import checkpoint
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import Trainer
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.train import checkpoint as jax_checkpoint

torch.set_num_threads(1)

VALIDATION_LIMIT = 1e-4  # both scripts' own limit on the scorer check
VOLATILE = ("exported_at", "scoring_latency_ms", "scorer_validation_max_diff")
SMALL = ["--benchmark-requests", "3"]
V, DIM = 300, 16


def _jax_export(argv: list[str], monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", ["export_onnx.py", *argv])
    load_jax_script("pipeline/export_onnx.py").main()


def _port_export(argv: list[str]) -> dict:
    return export_onnx.main([*argv, "--device", "cpu"])


def _assert_same_export(port: Path, jax_dir: Path, returned: dict, differ: tuple = ()) -> tuple[dict, dict]:
    got_bytes, want_bytes = ((d / "item_embeddings.npy").read_bytes() for d in (port, jax_dir))
    assert got_bytes == want_bytes
    got, want = (json.loads((d / "model_metadata.json").read_text()) for d in (port, jax_dir))
    assert got == returned
    assert list(got) == list(want)
    for meta in (got, want):
        assert 0.0 <= meta["scorer_validation_max_diff"] < VALIDATION_LIMIT
        assert list(meta["scoring_latency_ms"]) == ["p50", "p95", "mean"]
        assert meta["onnx_exported"] is False  # onnx is not installed
    skip = (*VOLATILE, *differ)
    assert {k: v for k, v in got.items() if k not in skip} == {k: v for k, v in want.items() if k not in skip}
    return got, want


def test_demo_mode_writes_the_jax_scripts_table(tmp_path, monkeypatch):
    flags = ["--num-items", "1000", "--embedding-dim", "24", *SMALL]
    _jax_export([*flags, "--output-dir", str(tmp_path / "jax")], monkeypatch)
    got = _port_export([*flags, "--output-dir", str(tmp_path / "port")])
    meta, _ = _assert_same_export(tmp_path / "port", tmp_path / "jax", got)
    assert meta["mode"] == "demo" and (meta["num_items"], meta["embedding_dim"]) == (1000, 24)


def test_custom_mode_writes_the_jax_scripts_table(tmp_path, monkeypatch):
    source = tmp_path / "table.npy"
    np.save(source, np.random.default_rng(3).normal(size=(257, 12)))  # float64 on disk
    flags = ["--mode", "custom", "--embeddings-file", str(source), *SMALL]
    _jax_export([*flags, "--output-dir", str(tmp_path / "jax")], monkeypatch)
    got = _port_export([*flags, "--output-dir", str(tmp_path / "port")])
    meta, _ = _assert_same_export(tmp_path / "port", tmp_path / "jax", got)
    assert meta["source"] == str(source) and np.load(tmp_path / "port" / "item_embeddings.npy").dtype == np.float32


def _jax_and_port_checkpoints(name: str, root: Path) -> tuple[Path, Path, np.ndarray]:
    """One model's weights (drawn from a key other than the script's
    template key) as a JAX checkpoint and, through convert.from_jax_params,
    as a port checkpoint; and the JAX table."""
    extra = {"laplacian_k": 4} if name.startswith("graph_transformer") else {}
    model = jax_create_model(name, num_items=V, embedding_dim=DIM, hidden_dim=DIM, **extra)
    params, state = model.init_params(jax.random.key(5))
    params, state = jax.tree.map(np.asarray, (params, state))
    cfg = dataclasses.asdict(model.config)
    jax_dir, port_dir = root / "jax_ckpt", root / "port_ckpt"
    jax_checkpoint.save(jax_dir, params, state, (), {"model_name": name, "model_config": cfg, "epoch": 3,
                                                     "best_val_metric": 0.25})
    weights, buffers = convert.from_jax_params(params, state, cfg, name)
    fields = dict(cfg)
    port = registry.create_model(name, fields.pop("num_items"), device="cpu", **fields)
    port.load_state_dict({**weights, **buffers})
    checkpoint.save(port_dir, port, epoch=3, best_val_metric=0.25)
    return jax_dir, port_dir, params["item_embedding"]


@pytest.mark.parametrize("name", registry.MODEL_NAMES)
def test_production_mode_exports_the_checkpoints_table_as_the_jax_script(name, tmp_path, monkeypatch):
    jax_ckpt, port_ckpt, table = _jax_and_port_checkpoints(name, tmp_path)
    _jax_export(["--mode", "production", "--checkpoint", str(jax_ckpt), "--output-dir", str(tmp_path / "jax"),
                 *SMALL], monkeypatch)
    got = _port_export(["--mode", "production", "--checkpoint", str(port_ckpt),
                        "--output-dir", str(tmp_path / "port"), *SMALL])
    meta, want = _assert_same_export(tmp_path / "port", tmp_path / "jax", got, differ=("source",))
    assert (meta["source"], want["source"]) == (str(port_ckpt), str(jax_ckpt))
    assert (meta["model_name"], meta["epoch"], meta["best_val_metric"]) == (name, 3, 0.25)
    exported = np.load(tmp_path / "port" / "item_embeddings.npy")
    # The padded table, phantom rows included, as the JAX script writes it.
    assert exported.shape == (padded_rows(V), DIM) == table.shape and meta["num_items"] == padded_rows(V)
    np.testing.assert_array_equal(exported, table)


def _tiny_corpus(sessions: int = 64):
    rng = np.random.default_rng(0)
    lengths = rng.integers(3, 10, sessions)
    total = int(lengths.sum())
    sid, ts = np.repeat(np.arange(sessions), lengths), np.arange(total)
    edges = (rng.integers(1, V, 3000), rng.integers(1, V, 3000))
    return port_batching.SessionDataset((sid, ts, rng.integers(1, V, total)), edges, num_items=V)


def test_a_lazy_checkpoint_exports_its_materialized_table(tmp_path):
    ds = _tiny_corpus()
    model = registry.create_model("graph_transformer_optimized", V, device="cpu", embedding_dim=DIM,
                                  hidden_dim=DIM, laplacian_k=4)
    optimizer = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True)
    before_materialize: list = []
    materialize = optimizer.materialize

    def keep_and_materialize(m, state):
        before_materialize.append(m.item_embedding.detach().clone())
        return materialize(m, state)

    optimizer.materialize = keep_and_materialize
    trainer = Trainer(model, lambda epoch: port_batching.iterate_batches(ds, 16, shuffle=True, seed=epoch,
                                                                          engine="numpy"),
                      lambda: port_batching.iterate_batches(ds, 16, engine="numpy"), optimizer=optimizer,
                      output_dir=tmp_path / "run", max_epochs=2, sparse_embedding_grads=True, device="cpu")
    trainer.train()
    ckpt = tmp_path / "run" / "checkpoint_latest"
    _port_export(["--mode", "production", "--checkpoint", str(ckpt), "--output-dir", str(tmp_path / "out"),
                  *SMALL])
    exported = np.load(tmp_path / "out" / "item_embeddings.npy")
    np.testing.assert_array_equal(exported, model.item_embedding.detach().numpy())
    saved = torch.load(ckpt / checkpoint.OPTIMIZER_FILE, weights_only=True)
    assert int(saved["count"]) > 0 and bool((saved["last_step"] == saved["count"]).all())
    # The rows the last materialize caught up differ from what the lazy table held before it.
    assert not np.array_equal(exported, before_materialize[-1].numpy())
