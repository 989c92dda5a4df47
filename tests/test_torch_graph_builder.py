"""The port's pandas-free co-occurrence graph builder against the JAX package's.

``build_co_event_graph`` must give the JAX builder's edges: the same
(item_i, item_j) set, and per edge the same count, last canonical-source
timestamp and event-pair histogram, and the same stats, over seeded corpora
with mixed event types, ties in timestamp and in count, self-loops (an item
twice in a session) and sessions shorter than the window. The JAX builder
orders rows by pandas' unstable sort on count; the edges are compared after
sorting both by (item_i, item_j), and the port's rows and histogram keys in
their order against the JAX builder's (count descending, ties as pandas'
sort leaves them). ``save_edges`` then ``load_edges`` round-trips through
the CSV and the npz, and the CSV is the JAX writer's file byte for byte.
"""

import csv
import json

import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch.data import graph as port
from gat_recommendation_tpu.data import graph as ref

torch.set_num_threads(1)

EVENTS = np.array(["view", "addtocart", "transaction"])


def _sessions(seed, n_events=2500, n_sessions=300, n_items=60):
    """Few items (self-loops and repeated pairs are common, counts tie),
    timestamps from a small range (ties inside sessions), three event types,
    and some single-event and two-event sessions."""
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, n_sessions, n_events)
    sid[:40] = np.arange(1000, 1040)  # forty single-event sessions
    sid[40:60] = np.repeat(np.arange(2000, 2010), 2)  # ten two-event sessions
    return {
        "session_id": sid,
        "timestamp": rng.integers(0, 40, n_events),
        "itemid": rng.integers(1, n_items, n_events),
        "event": EVENTS[rng.choice(3, n_events, p=[0.7, 0.2, 0.1])],
    }


def _by_pair(edges: dict) -> dict:
    order = np.lexsort((edges["item_j"], edges["item_i"]))
    out = {k: np.asarray(edges[k])[order] for k in ("item_i", "item_j", "count", "last_ts")}
    out["event_pair_hist"] = [edges["event_pair_hist"][i] for i in order]
    return out


def _jax_edges(cols, window):
    df, stats = ref.build_co_event_graph(pd.DataFrame(cols), window)
    edges = {k: df[k].to_numpy(np.int64) for k in ("item_i", "item_j", "count", "last_ts")}
    edges["event_pair_hist"] = list(df["event_pair_hist"])
    return edges, stats


def _assert_same_edges(got, want):
    g, w = _by_pair(got), _by_pair(want)
    for k in ("item_i", "item_j", "count", "last_ts"):
        assert np.array_equal(g[k], w[k]), k
    assert g["event_pair_hist"] == w["event_pair_hist"]


@pytest.mark.parametrize("window", [1, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_builder_matches_the_jax_builder(seed, window):
    cols = _sessions(seed)
    got, got_stats = port.build_co_event_graph(cols, window)
    want, want_stats = _jax_edges(cols, window)
    _assert_same_edges(got, want)
    assert got_stats == want_stats
    assert (got["item_i"] == got["item_j"]).any()  # self-loops kept
    assert len(np.unique(got["count"])) < len(got["count"])  # ties in count


def test_one_event_type_and_string_session_ids():
    """The bench's corpus: every event a view, passed as one scalar; session
    ids that are strings."""
    cols = _sessions(3)
    cols["event"] = np.full(len(cols["itemid"]), "view")
    cols["session_id"] = np.char.add("s", cols["session_id"].astype(str))
    want, want_stats = _jax_edges(cols, 5)
    got, got_stats = port.build_co_event_graph((cols["session_id"], cols["timestamp"], cols["itemid"], "view"))
    _assert_same_edges(got, want)
    assert got_stats == want_stats and all(h.keys() == {"view_view"} for h in got["event_pair_hist"])


@pytest.mark.parametrize("events", [1, 3])
def test_sessions_shorter_than_the_window(events):
    """Sessions of one event have no pairs; a corpus of a single event gives
    the empty graph and the JAX builder's empty stats."""
    cols = {k: v[:events] for k, v in _sessions(4).items()}
    cols["session_id"] = np.zeros(events, np.int64)
    got, got_stats = port.build_co_event_graph(cols, 5)
    want, want_stats = _jax_edges(cols, 5)
    assert got_stats == want_stats
    if events == 1:
        assert got_stats == {"num_nodes": 0, "num_edges": 0, "avg_degree": 0.0}
        assert all(len(got[k]) == 0 for k in port.EDGE_COLUMNS)
    else:
        _assert_same_edges(got, want)


def test_rows_are_ordered_by_count_then_pair():
    """Count descending; rows of equal count, and the keys of each
    histogram, in the JAX builder's order."""
    cols = _sessions(5)
    got, _ = port.build_co_event_graph(cols, 5)
    want, _ = _jax_edges(cols, 5)
    assert np.all(np.diff(got["count"]) <= 0) and len(got["count"]) > 100
    for k in ("item_i", "item_j", "count", "last_ts"):
        assert np.array_equal(got[k], want[k]), k
    assert [list(h) for h in got["event_pair_hist"]] == [list(h) for h in want["event_pair_hist"]]


@pytest.mark.parametrize("suffix", [".csv", ".npz"])
def test_save_edges_round_trips_through_load_edges(tmp_path, suffix):
    edges, _ = port.build_co_event_graph(_sessions(6), 5)
    port.save_edges(edges, tmp_path / "graph_edges.csv", tmp_path / "graph_edges.npz")
    item_i, item_j = port.load_edges(tmp_path / f"graph_edges{suffix}")
    assert np.array_equal(item_i, edges["item_i"]) and np.array_equal(item_j, edges["item_j"])
    if suffix == ".npz":
        with np.load(tmp_path / "graph_edges.npz") as z:
            assert sorted(z.files) == ["count", "item_i", "item_j", "last_ts"]
            assert all(np.array_equal(z[k], edges[k]) for k in z.files)


def test_the_csv_parses_to_the_jax_writers_rows(tmp_path):
    cols = _sessions(7)
    edges, _ = port.build_co_event_graph(cols, 5)
    port.save_edges(edges, tmp_path / "port.csv")
    df, _ = ref.build_co_event_graph(pd.DataFrame(cols), 5)
    ref.save_edges(df, tmp_path / "jax.csv")

    def rows(path):
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            return header, sorted((int(r[0]), int(r[1]), int(r[2]), int(r[3]), json.loads(r[4])) for r in reader)

    assert rows(tmp_path / "port.csv") == rows(tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_tuple_and_mapping_columns_agree():
    cols = _sessions(8)
    a, _ = port.build_co_event_graph(cols)
    b, _ = port.build_co_event_graph(tuple(cols[k] for k in ("session_id", "timestamp", "itemid", "event")))
    assert all(np.array_equal(a[k], b[k]) for k in port.EDGE_COLUMNS[:4])
    assert a["event_pair_hist"] == b["event_pair_hist"]
