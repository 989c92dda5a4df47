"""The port's utils and its data-loading names against the JAX package's.

set_seed, the JSON and YAML helpers (``load_config`` equals
``yaml.safe_load`` and the JAX ``load_config`` on every file of
``configs/``), the timer, device memory on the CPU, the profiler trace,
the H100 roofline, and the reference's ``DataLoader`` surface (the same
batches as the JAX one, numpy engine). Equality, no tolerance.
"""

import os
import random
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from gat_recommendation_torch.data.batching import SessionDataset
from gat_recommendation_torch.train import dataloader
from gat_recommendation_torch.utils import io, profiler, roofline, seed
from gat_recommendation_tpu.data.batching import SessionDataset as JaxSessionDataset
from gat_recommendation_tpu.train import dataloader as jax_dataloader
from gat_recommendation_tpu.utils import io as jax_io

torch.set_num_threads(1)

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))


def test_set_seed_seeds_every_generator(monkeypatch):
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    gen = seed.set_seed(7)
    draws = (random.random(), np.random.rand(), torch.rand(1), torch.rand(1, generator=gen))
    gen = seed.set_seed(7)
    assert draws == (random.random(), np.random.rand(), torch.rand(1), torch.rand(1, generator=gen))
    assert os.environ["PYTHONHASHSEED"] == "7"


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_reads_the_repo_configs(path, tmp_path):
    got = io.load_config(path)
    assert got == yaml.safe_load(path.read_text()) == jax_io.load_config(path)
    io.save_config(got, tmp_path / "again.yaml")
    assert io.load_config(tmp_path / "again.yaml") == got


def test_json_helpers_take_numpy_values(tmp_path):
    data = {"i": np.int64(3), "f": np.float32(0.5), "a": np.arange(3), "nested": {"x": [1, 2]}}
    io.save_json(data, tmp_path / "port" / "d.json")
    jax_io.save_json(data, tmp_path / "jax" / "d.json")
    assert (tmp_path / "port" / "d.json").read_bytes() == (tmp_path / "jax" / "d.json").read_bytes()
    assert io.load_json(tmp_path / "port" / "d.json") == {"i": 3, "f": 0.5, "a": [0, 1, 2], "nested": {"x": [1, 2]}}
    with pytest.raises(TypeError):
        io.save_json({"s": {1, 2}}, tmp_path / "bad.json")


def test_timer_memory_and_trace(tmp_path):
    results = {}
    with profiler.timer("block", results=results) as record:
        sum(range(1000))
    assert record["seconds"] == results["block"] >= 0
    memory = profiler.measure_memory("cpu")
    assert memory["allocated_mb"] == memory["peak_mb"] == memory["limit_mb"] == 0.0 and "note" in memory
    with profiler.trace(None):
        pass
    with profiler.trace(str(tmp_path)):
        torch.ones(4) @ torch.ones(4)
    assert any(tmp_path.rglob("*.json"))


def test_roofline_on_the_h100():
    spec = roofline.H100_SXM
    assert (spec.peak_f32_tflops, spec.hbm_gb_per_s, spec.hbm_gb) == (67.0, 3350.0, 80.0)
    adamw = roofline.embedding_adamw_roofline(467_456, 256, measured_seconds=1.2e-3)
    assert adamw.bound == "memory"
    assert adamw.speed_of_light_seconds == pytest.approx(7 * 467_456 * 256 * 4 / 3.35e12)
    assert 0 < adamw.fraction_of_sol < 1
    score = roofline.scorer_roofline(512, 467_456, 256)
    assert score.bound == "compute" and score.fraction_of_sol is None
    assert score.report()["sol_ms"] == pytest.approx(2 * 512 * 467_456 * 256 / 67e12 * 1e3)


def test_dataloader_yields_the_jax_dataloaders_batches():
    rng = np.random.default_rng(1)
    lengths = rng.integers(3, 12, 60)
    sid, ts = np.repeat(np.arange(60), lengths), np.arange(int(lengths.sum()))
    items = rng.integers(1, 200, len(ts))
    edges = (rng.integers(1, 200, 800), rng.integers(1, 200, 800))
    port = dataloader.DataLoader(SessionDataset((sid, ts, items), edges, num_items=200), 16, shuffle=True,
                                 seed=3, engine="numpy")
    ref = jax_dataloader.DataLoader(
        JaxSessionDataset(pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": items}), edges, num_items=200),
        16, shuffle=True, seed=3, engine="numpy")
    assert len(port) == len(ref) == 4
    for _epoch in range(2):
        for a, b in zip(port, ref, strict=True):
            for name in ("node_ids", "adj", "targets", "negatives", "sample_mask"):
                assert np.array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name))), name
    assert dataloader.collate_fn is dataloader.collate
