"""The port's benches on the CPU, at a tiny size.

``gat_recommendation_torch.bench.make_corpus`` draws the JAX bench's numpy
streams (``bench.py``, imported here by path) and builds the graph with the
port's pandas-free builder: the same sessions, the same edges, and batches
equal bit for bit to those of the JAX package's C++ engine. ``main_e2e`` and
``main_device`` run end to end with ``device="cpu"`` over a 5,000-item
catalog and print a JSON line with the JAX bench's keys under ``torch_``
metric names, the device named; each timed window's host account says
where its seconds went, and ``scripts/bench_windows.py`` runs the bench in
turns and flags stalled epochs. The latency bench's ``measure`` gives
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
    assert set(detail["trace_collection"]) == {"objects", "s", "freed_bytes"}  # the trace's garbage, collected
    rows = detail["touched_rows"]
    assert rows["steps"] == 2 * detail["steps_per_epoch"] and 0 < rows["unique_rows_mean"] <= rows["unique_rows_max"]
    assert 0 <= rows["catch_up_terms_at_tail"] <= 1 and rows["catch_up_terms_mean"] >= 0


def test_each_window_accounts_where_its_host_seconds_went():
    """The detail's ``host``: for the warm-up, short and long windows, the
    host seconds of each epoch (adding up to at most the window), of the
    waits on the prefetch thread, the chained and the single steps and the
    fence (together at most the window, and most of it on the CPU), the
    longest of those and the collections that ran inside; no graph is
    captured on the CPU. The set-up's full collection is reported."""
    result = bench.main_e2e(1200, 0, 1, 3, lazy=True, transfer_workers=1, num_items=ITEMS, device="cpu")
    detail = result["_detail"]
    assert set(detail["host"]) == {"warm", "short", "long"}
    for window, epochs in (("warm", 2), ("short", 1), ("long", 2)):
        acct, wall = detail["host"][window], detail[f"t_{window}"]
        assert len(acct["epoch_host_s"]) == epochs and sum(acct["epoch_host_s"]) <= wall
        spent = acct["wait_s"] + acct["chained_s"] + acct["single_s"] + acct["fence_s"]
        assert 0.5 * wall < spent <= wall, window
        assert acct["chained_s"] > 0 and acct["single_s"] > 0  # a group of 3, then a single step
        assert 0 < acct["longest_s"] <= spent and acct["longest"].split()[0] in ("wait", "chained", "single", "fence")
        assert acct["captured"] == 0 and acct["collections"] >= 0 and acct["gc_s"] >= 0
    # The set-up's collection: what the caller left; no card memory here.
    assert set(detail["setup_collection"]) == {"objects", "s", "freed_bytes"}
    assert detail["setup_collection"]["freed_bytes"] == 0 and detail["setup_collection"]["objects"] >= 0


def test_bench_windows_runs_in_turns_and_finds_stalls(tmp_path, capsys):
    """``scripts/bench_windows.py`` on the CPU: a mesh run and a plain run,
    a JSON line each with both timed windows' host accounts, every result in
    ``--out``; an epoch over twice the median is a stall."""
    from gat_recommendation_torch.scripts import bench_windows

    out = tmp_path / "windows.jsonl"
    summary = bench_windows.main(["--rounds", "1", "--chain", "2", "--sessions", "300", "--epochs", "1",
                                  "--num-items", str(ITEMS), "--device", "cpu", "--out", str(out)])
    assert summary["runs"] == 2 and [line["mesh"] for line in summary["lines"]] == ["1x1", None]
    assert all(set(line["host"]) == {"short", "long"} for line in summary["lines"])
    assert [json.loads(line)["_detail"]["mesh"] for line in out.read_text().splitlines()] == ["1x1", None]
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[-1]) == {"runs": 2, "stalled": summary["stalled"], "not_positive": 0}  # no card: no smi line
    assert not torch.distributed.is_initialized()
    steady = {"host": {"short": {"epoch_host_s": [1.0]}, "long": {"epoch_host_s": [1.1, 0.9]}}}
    stalled = {"host": {"short": {"epoch_host_s": [2.5]}, "long": {"epoch_host_s": [1.0, 1.0]}}}
    assert bench_windows.stalled_epochs(steady) == [] and bench_windows.stalled_epochs(stalled) == [2.5]


def test_main_device_runs_and_prints_one_json_line(capsys):
    result = bench.main_device(False, num_items=ITEMS, device="cpu", steps=(1, 3), num_batches=2)
    bench.emit(result)
    _check_line(capsys.readouterr().out, "torch_train_sessions_per_sec_per_chip_eager")


def test_bench_over_a_1x1_mesh_runs_chained_steps(capsys, monkeypatch):
    """``--mesh 1x1 --chain 4`` on the CPU: full groups go through the
    chained sharded step (its calls counted here) and the partial ones
    through single steps; one JSON line named for the mesh, the chain in its
    detail; the group is gone afterwards."""
    from gat_recommendation_torch.parallel import distributed, steps

    slots = []
    make = steps.make_chained_sharded_sparse_train_step

    def counted(*args):
        chained = make(*args)

        def run(batches, gidxs, block):
            slots.append(block.shape[0])
            return chained(batches, gidxs, block)

        return run

    monkeypatch.setattr(steps, "make_chained_sharded_sparse_train_step", counted)
    try:
        result = bench.main_e2e(2400, 0, 1, 4, lazy=True, num_items=ITEMS, device="cpu", mesh_shape=(1, 1))
    finally:
        distributed.shutdown()
    detail = result["_detail"]
    assert detail["mesh"] == "1x1" and detail["chain"] == 4 and result["value"] > 0
    assert slots and set(slots) == {4} and 4 * len(slots) < 5 * detail["steps_per_epoch"]  # and single steps
    bench.emit(result)
    _check_line(capsys.readouterr().out, "torch_train_sessions_per_sec_per_chip_e2e_mesh1x1")
    assert not torch.distributed.is_initialized()


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
