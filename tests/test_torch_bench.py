"""The port's benches on the CPU, at a tiny size.

``gat_recommendation_torch.bench.make_corpus`` draws the JAX bench's numpy
streams (``bench.py``, imported here by path) and builds the graph with the
port's pandas-free builder: the same sessions, the same edges, and batches
equal bit for bit to those of the JAX package's C++ engine. ``main_e2e`` and
``main_device`` run end to end with ``device="cpu"`` over a 5,000-item
catalog and print a JSON line with the JAX bench's keys under ``torch_``
metric names, the device named. The latency bench's ``measure`` gives
p50 <= p95 <= p99 over a CPU Recommender.
"""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gat_recommendation_torch import bench
from gat_recommendation_torch.data import batching as port_batching
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.serving import latency_bench
from gat_recommendation_torch.serving.recommender import Recommender
from gat_recommendation_torch.train import checkpoint
from gat_recommendation_tpu.data import batching as ref_batching
from gat_recommendation_tpu.data import native as ref_native

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ITEMS = 5000
BATCH_FIELDS = ("node_ids", "node_mask", "adj", "num_nodes", "targets", "negatives", "sample_mask")


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def corpora(jax_bench):
    return jax_bench.make_corpus(2000, num_items=ITEMS), bench.make_corpus(2000, num_items=ITEMS)


def test_make_corpus_gives_the_jax_benchs_sessions_and_edges(corpora):
    (jax_ds, jax_stats), (port_ds, port_stats) = corpora
    assert port_stats == jax_stats and port_stats["num_edges"] > 1000
    assert len(port_ds) == len(jax_ds) == 2000 and port_ds.num_items == jax_ds.num_items == ITEMS
    for name in ("items", "offsets", "unique_counts"):
        assert np.array_equal(getattr(port_ds, name), getattr(jax_ds, name)), name
    assert np.array_equal(port_ds.graph.indptr, jax_ds.graph.indptr)
    assert np.array_equal(port_ds.graph.indices, jax_ds.graph.indices)


def test_make_corpus_batches_equal_the_jax_engines(corpora):
    """The JAX engine's first build runs ``make -C native``; its load is
    retried while another test process is still building it."""
    for _ in range(120):
        if ref_native.available():
            break
        ref_native._load_attempted = False
        time.sleep(1.0)
    else:
        pytest.fail("the JAX package's C++ engine did not build (make -C native)")
    (jax_ds, _), (port_ds, _) = corpora
    want = list(ref_batching.iterate_batches(jax_ds, bench.BATCH_SIZE, shuffle=True, seed=1, engine="native"))
    got = list(port_batching.iterate_batches(port_ds, bench.BATCH_SIZE, shuffle=True, seed=1, engine="native",
                                             workers=2))
    assert len(got) == len(want) >= 4
    for w, g in zip(want, got):
        for f in BATCH_FIELDS:
            assert np.array_equal(np.asarray(getattr(w, f)), getattr(g, f).numpy()), f


def _check_line(out: str, metric: str) -> dict:
    lines = out.strip().splitlines()
    line = json.loads(lines[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert line["metric"] == metric and line["unit"] == "sessions/s" and line["device"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / bench.BASELINE_SESSIONS_PER_SEC)
    return line


@pytest.mark.parametrize("chain,workers,transfer_workers", [(1, 0, 1), (2, 2, 2)])
def test_main_e2e_runs_and_prints_one_json_line(capsys, chain, workers, transfer_workers):
    result = bench.main_e2e(600, workers, 1, chain, lazy=True, transfer_workers=transfer_workers,
                            num_items=ITEMS, device="cpu", profile=True)
    detail = result["_detail"]
    bench.emit(result)
    out, err = capsys.readouterr()
    _check_line(out, "torch_train_sessions_per_sec_per_chip_e2e")
    assert "[bench detail]" in err and "nvidia-smi" in err  # no card here: the line says so
    assert detail["chain"] == chain and detail["workers"] == workers
    assert detail["transfer_workers"] == transfer_workers and detail["engine"] == "native"
    assert detail["steps_per_epoch"] >= 2 and detail["epoch_s"] == detail["t_long"] - detail["t_short"]
    assert detail["device_idle_share"] == "not measured"  # a CPU run measures no device
    rows = detail["touched_rows"]
    assert rows["steps"] == 2 * detail["steps_per_epoch"] and 0 < rows["unique_rows_mean"] <= rows["unique_rows_max"]
    assert 0 <= rows["catch_up_terms_at_tail"] <= 1 and rows["catch_up_terms_mean"] >= 0


def test_main_device_runs_and_prints_one_json_line(capsys):
    result = bench.main_device(False, num_items=ITEMS, device="cpu", steps=(1, 3), num_batches=2)
    bench.emit(result)
    _check_line(capsys.readouterr().out, "torch_train_sessions_per_sec_per_chip_eager")


def test_mesh_is_not_ported():
    """What of the mesh is not ported: chained steps under it (ROADMAP A8b)."""
    with pytest.raises(NotImplementedError, match="A8b"):
        bench.main_e2e(100, 0, 1, 32, lazy=True, num_items=ITEMS, device="cpu", mesh_shape=(1, 1))


def test_bench_over_a_1x1_mesh_runs_and_leaves_its_process_group(capsys):
    """``--mesh 1x1`` on the CPU: a gloo group of one, the sharded lazy step,
    one JSON line named for the mesh; the group is gone afterwards."""
    from gat_recommendation_torch.parallel import distributed

    try:
        result = bench.main_e2e(300, 0, 1, 1, lazy=True, num_items=ITEMS, device="cpu", mesh_shape=(1, 1))
    finally:
        distributed.shutdown()
    assert result["_detail"]["mesh"] == "1x1" and result["value"] > 0
    bench.emit(result)
    _check_line(capsys.readouterr().out, "torch_train_sessions_per_sec_per_chip_e2e_mesh1x1")
    assert not torch.distributed.is_initialized()


def test_bench_asks_for_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main_e2e(100, 0, 1, num_items=ITEMS)


def test_latency_bench_percentiles_are_ordered(tmp_path, caplog):
    gen = torch.Generator().manual_seed(0)
    model = create_model("graph_transformer_optimized", 400, embedding_dim=16, hidden_dim=16, laplacian_k=4,
                         device="cpu", generator=gen)
    checkpoint.save(tmp_path / "ckpt", model, epoch=0, best_val_metric=0.0)
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "edges.npz", item_i=rng.integers(1, 400, 3000), item_j=rng.integers(1, 400, 3000))
    rec = Recommender(tmp_path / "ckpt", tmp_path / "edges.npz", device="cpu")
    reqs = latency_bench.make_requests(rec.num_items, 40)
    assert all(2 <= len(r.session_items) <= 11 and r.k == 10 for r in reqs)
    got = latency_bench.measure(rec, reqs)
    assert got["n"] == 40 and 0 < got["p50"] <= got["p95"] <= got["p99"]
    with caplog.at_level("WARNING"):
        results = latency_bench.run(tmp_path / "ckpt", tmp_path / "edges.npz", num_requests=20, device="cpu")
    assert results["device"] == "cpu" and results["exact"]["n"] == 20 and "int8" not in results
    assert "int8 scoring unavailable" in caplog.text
