"""The port's pandas-free data pipeline against the JAX package's.

Both generators column by column for three seeds and the structured flags;
``sessionize_events``, ``compute_session_stats``, ``create_temporal_splits``
and the remap functions equal the JAX functions on the same inputs; the CSV
writer gives pandas' bytes and the reader pandas' dtypes; each data-stage
entry point against the JAX script of the same stage (loaded from
``scripts/data/`` with importlib) on a small corpus of both generators, the
remap included: every output file byte-equal. No tolerance: equality.
"""

import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch.data import csv_io, ordering, remap, sessionize, splits, synthetic
from gat_recommendation_torch.scripts.data import (
    build_graph,
    generate_synthetic_data,
    remap_ids,
    temporal_split,
)
from gat_recommendation_torch.scripts.data import sessionize as sessionize_stage
from gat_recommendation_tpu.data import remap as jax_remap
from gat_recommendation_tpu.data import sessionize as jax_sessionize
from gat_recommendation_tpu.data import splits as jax_splits
from gat_recommendation_tpu.data import synthetic as jax_synthetic

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
STRUCTURED = dict(successors_per_item=4, cross_cluster_successors=1, dirichlet_alpha=0.1)


def _assert_frame_equal(got: dict, want: pd.DataFrame) -> None:
    assert list(got) == list(want.columns)
    for name in want.columns:
        w = want[name].to_numpy()
        g = np.asarray(got[name])
        assert len(g) == len(w), name
        if w.dtype.kind == "f" or name == "transactionid":
            gf, wf = pd.to_numeric(pd.Series(g)).to_numpy(float), pd.to_numeric(pd.Series(w)).to_numpy(float)
            np.testing.assert_array_equal(gf, wf, err_msg=name)
        else:
            assert np.array_equal(g.astype(str) if w.dtype.kind == "O" else g, w.astype(str) if w.dtype.kind == "O" else w), name


def _frame(columns: dict) -> pd.DataFrame:
    return pd.DataFrame({k: np.asarray(v) for k, v in columns.items()})


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_synthetic_events_match_the_jax_generator(seed):
    got = synthetic.generate_synthetic_events(300, 150, seed=seed)
    want = jax_synthetic.generate_synthetic_events(300, 150, seed=seed)
    _assert_frame_equal(got, want)
    # The object column keeps the JAX frame's NaN pattern and int values.
    assert [v != v for v in got["transactionid"]] == [v != v for v in want["transactionid"]]


@pytest.mark.parametrize("flags", [{}, STRUCTURED, dict(num_active=80, num_clusters=3, noise_prob=0.3)])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_structured_events_match_the_jax_generator(seed, flags):
    got = synthetic.generate_structured_events(400, 600, seed=seed, **flags)
    want = jax_synthetic.generate_structured_events(400, 600, seed=seed, **flags)
    _assert_frame_equal(got, want)


def _events(seed=3):
    """Raw events through the CSV boundary, as stage 02 reads them."""
    return synthetic.generate_structured_events(600, 500, seed=seed, **STRUCTURED)


@pytest.mark.parametrize("gap,min_length", [(30, 3), (5, 2), (60, 5)])
def test_sessionize_and_stats_match_the_jax_functions(gap, min_length):
    # Visitors own several sessions each (a visitor boundary and the gap
    # both cut); a 5-min gap also cuts inside the generated sessions.
    events = csv_io.roundtrip(_events())
    got = sessionize.sessionize_events(events, gap, min_length)
    want = jax_sessionize.sessionize_events(_frame(events), gap, min_length)
    _assert_frame_equal(got, want)
    assert json.dumps(sessionize.compute_session_stats(got)) == json.dumps(
        jax_sessionize.compute_session_stats(want))


@pytest.mark.parametrize("ratios,blackout", [((0.7, 0.15, 0.15), 2), ((0.5, 0.25, 0.25), 0), ((0.8, 0.1, 0.1), 7)])
def test_temporal_splits_match_the_jax_function(ratios, blackout):
    sessions = csv_io.roundtrip(sessionize.sessionize_events(csv_io.roundtrip(_events(4))))
    got = splits.create_temporal_splits(sessions, *ratios, blackout_days=blackout)
    want = jax_splits.create_temporal_splits(_frame(sessions), *ratios, blackout_days=blackout)
    for g, w in zip(got[:3], want[:3]):
        _assert_frame_equal(g, w.reset_index(drop=True))
    assert json.dumps(got[3]) == json.dumps(want[3])


def test_remap_matches_the_jax_functions():
    rng = np.random.default_rng(5)
    frames = [{"itemid": rng.integers(0, 900, 200), "x": np.arange(200)} for _ in range(3)]
    edges = (rng.integers(0, 900, 300), rng.integers(0, 900, 300))
    got = remap.build_id_map(*frames, edges)
    want = jax_remap.build_id_map(*(pd.DataFrame(f) for f in frames), edges)
    assert np.array_equal(got, want)
    assert np.array_equal(remap.remap_sessions(frames[0], got)["itemid"],
                          jax_remap.remap_sessions(pd.DataFrame(frames[0]), want)["itemid"].to_numpy())
    for g, w in zip(remap.remap_edges(*edges, got), jax_remap.remap_edges(*edges, want)):
        assert np.array_equal(g, w)
    with pytest.raises(KeyError):
        remap.remap_edges(np.array([901]), np.array([1]), got)


def test_csv_writer_and_reader_follow_pandas():
    cols = {
        "i": np.array([1, -2, 3]),
        "f": np.array([1.5, np.nan, 1e16]),
        "o": np.array([np.nan, 11533, 7], dtype=object),
        "s": np.array(["a,b", 'q"r', "plain"]),
    }
    buf = io.StringIO()
    csv_io.write_csv(cols, buf)
    assert buf.getvalue() == _frame(cols).to_csv(index=False)
    back = csv_io.roundtrip(cols)
    want = pd.read_csv(io.StringIO(buf.getvalue()))
    for name in cols:
        assert back[name].dtype.kind == ("U" if want[name].dtype.kind in "OT" else want[name].dtype.kind), name
    # The int column with a gap comes back float64 and is written as pandas writes it.
    buf2 = io.StringIO()
    csv_io.write_csv(back, buf2)
    assert buf2.getvalue() == want.to_csv(index=False)
    assert back["o"].dtype == np.float64 and "11533.0" in buf2.getvalue()


def test_session_reader_refuses_an_empty_itemid(tmp_path):
    """An empty itemid field makes pandas' column float64 with NaN; the
    dataset's reader raises rather than cast the NaN to an id."""
    from gat_recommendation_torch.data.batching import SessionDataset

    good, bad = tmp_path / "good.csv", tmp_path / "bad.csv"
    good.write_text("session_id,timestamp,itemid\n1,2,3\n1,3,4\n")
    bad.write_text("session_id,timestamp,itemid\n1,2,\n1,3,4\n")
    edges = (np.array([3]), np.array([4]))
    assert len(SessionDataset(str(good), edges)) == 1
    assert pd.read_csv(bad)["itemid"].dtype == np.float64
    with pytest.raises(ValueError, match="itemid"):
        SessionDataset(str(bad), edges)


def test_pandas_orders():
    rng = np.random.default_rng(9)
    values = rng.integers(0, 5, 3000)  # many ties: the unstable sort's own order
    got = ordering.pandas_argsort(values, ascending=False)
    want = pd.DataFrame({"v": values}).sort_values("v", ascending=False).index.to_numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(ordering.pandas_argsort(values), pd.Series(values).sort_values().index.to_numpy())
    words = np.array(["b", "a", "c", "a", "b", "d"] * 3 + ["c"])
    assert ordering.value_counts(words) == {k: int(v) for k, v in pd.Series(words).value_counts().items()}
    assert list(ordering.value_counts(words)) == list(pd.Series(words).value_counts().index)


# ---------------------------------------------------------------------------
# The stage entry points against the JAX scripts, file for file
# ---------------------------------------------------------------------------


def _jax_script(name: str):
    path = REPO / "scripts" / "data" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_jax_stage_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(name: str, argv: list[str], monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", [name, *argv])
    _jax_script(name).main()


STAGES = (
    # (JAX script, port module, argv from the data root and the generator flags)
    ("00_generate_synthetic_data", generate_synthetic_data,
     lambda d, extra: ["--output-file", f"{d}/raw/events.csv", "--num-sessions", "2000",
                       "--num-items", "3000", *extra]),
    ("02_sessionize", sessionize_stage,
     lambda d, extra: ["--input-file", f"{d}/raw/events.csv", "--output-file", f"{d}/interim/sessions.csv",
                       "--stats-file", f"{d}/interim/session_stats.json"]),
    ("03_temporal_split", temporal_split,
     lambda d, extra: ["--input-file", f"{d}/interim/sessions.csv", "--output-dir", f"{d}/processed"]),
    ("04_build_graph", build_graph,
     lambda d, extra: ["--input-file", f"{d}/processed/train.csv",
                       "--output-file", f"{d}/processed/graph_edges.csv",
                       "--stats-file", f"{d}/processed/graph_stats.json"]),
    ("05_remap_ids", remap_ids,
     lambda d, extra: ["--data-dir", f"{d}/processed", "--output-dir", f"{d}/processed_dense"]),
)


@pytest.mark.parametrize("extra", [[], ["--structured", "--successors-per-item", "4",
                                        "--cross-cluster-successors", "1", "--dirichlet-alpha", "0.1"]],
                         ids=["synthetic", "structured"])
def test_every_stage_writes_the_jax_scripts_bytes(extra, tmp_path, monkeypatch):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for jax_name, port_module, argv in STAGES:
        _run_jax(jax_name, argv(jax_dir, extra), monkeypatch)
        assert port_module.main(argv(port_dir, extra)) == 0
    files = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*") if p.is_file())
    assert sorted(p.relative_to(port_dir) for p in port_dir.rglob("*") if p.is_file()) == files
    assert len(files) == 17
    for f in files:
        assert (port_dir / f).read_bytes() == (jax_dir / f).read_bytes(), f
    # The stage boundaries did what they are there for.
    assert "transactionid" in (port_dir / "processed" / "train.csv").read_text().splitlines()[0]
