"""The port's dataset, collate, sparse-gradient index and epoch iterator vs the JAX package's.

Everything here is integer or boolean host data made from a seed: the port's
arrays must EQUAL the JAX package's (numpy engine, same seed). The port reads
sessions from plain arrays or a CSV (no DataFrame); the JAX package gets the
same rows as a DataFrame.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch.data import batching as port
from gat_recommendation_tpu.data import batching as ref

torch.set_num_threads(1)

BATCH_FIELDS = ("node_ids", "node_mask", "adj", "num_nodes", "targets", "negatives", "sample_mask")


def _corpus(seed=0, sessions=60, items=200, max_len=70, shuffle_rows=False):
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.geometric(0.25, sessions) + 2, 3, max_len)
    lengths[:3] = max_len  # a few sessions longer than the truncation length
    total = int(lengths.sum())
    sid = np.repeat(rng.permutation(sessions) + 100, lengths)
    ts = rng.integers(0, 40, total)  # many equal timestamps: the sort must be stable
    item = rng.integers(1, items, total)
    if shuffle_rows:
        order = rng.permutation(total)
        sid, ts, item = sid[order], ts[order], item[order]
    ei = rng.integers(1, items - 1, 3 * items)
    ej = np.minimum(ei + rng.integers(1, 8, 3 * items), items - 1)
    return sid, ts, item, (ei, ej)


def _datasets(**kw):
    sid, ts, item, edges = _corpus(**kw)
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": item, "event": "view"})
    return ref.SessionDataset(df, edges), port.SessionDataset((sid, ts, item), edges), df, edges


def _assert_same_dataset(a, b):
    assert len(a) == len(b) and a.num_items == b.num_items
    assert np.array_equal(np.asarray(a.session_ids), b.session_ids)
    for f in ("items", "offsets", "unique_counts"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.graph.indptr, b.graph.indptr) and np.array_equal(a.graph.indices, b.graph.indices)


@pytest.mark.parametrize("shuffle_rows", [False, True])
def test_dataset_from_arrays_equals_the_jax_packages(shuffle_rows):
    a, b, _, _ = _datasets(seed=1, shuffle_rows=shuffle_rows)
    _assert_same_dataset(a, b)
    assert np.diff(b.offsets).max() == 50  # truncated to the last 50 events


def test_dataset_from_csv_and_from_a_mapping(tmp_path):
    a, _, df, edges = _datasets(seed=2)
    df[["timestamp", "event", "itemid", "session_id"]].to_csv(tmp_path / "sessions.csv", index=False)
    _assert_same_dataset(a, port.SessionDataset(tmp_path / "sessions.csv", edges))
    columns = {k: df[k].to_numpy() for k in ("session_id", "timestamp", "itemid")}
    _assert_same_dataset(a, port.SessionDataset(columns, edges))
    few = port.SessionDataset(columns, edges, num_negatives=3, max_session_length=10, num_items=500)
    assert few.num_items == 500 and np.diff(few.offsets).max() == 10


def test_sample_and_negatives_equal_the_jax_packages():
    a, b, _, _ = _datasets(seed=3)
    for idx in (0, 7, len(a) - 1):
        sa_, sb_ = a.sample(idx, np.random.default_rng([5, idx])), b.sample(idx, np.random.default_rng([5, idx]))
        assert sa_["target"] == sb_["target"]
        for f in ("nodes", "edge_src", "edge_dst", "negatives"):
            assert np.array_equal(sa_[f], sb_[f]), f
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    assert np.array_equal(ref.sample_negatives(rng_a, {1, 2, 3}, 5, 6), port.sample_negatives(rng_b, {1, 2, 3}, 5, 6))
    assert np.array_equal(port.sample_negatives(rng_b, set(), 1, 4), np.zeros(4, np.int32))


@pytest.mark.parametrize("shuffle,seed,batch_size", [(False, 0, 16), (True, 3, 16), (True, 9, 7)])
def test_iterate_batches_and_grad_index_equal_the_jax_packages(shuffle, seed, batch_size):
    a, b, _, _ = _datasets(seed=4)
    ours = list(port.iterate_batches(b, batch_size, shuffle=shuffle, seed=seed))
    theirs = list(ref.iterate_batches(a, batch_size, shuffle=shuffle, seed=seed, engine="numpy"))
    assert len(ours) == len(theirs) > 3
    for x, y in zip(ours, theirs):
        for f in BATCH_FIELDS:
            got, want = getattr(x, f), getattr(y, f)
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), f
        assert x.batch_size == batch_size and x.nodes_per_session == y.nodes_per_session
        gx, gy = port.make_grad_index(x), ref.make_grad_index(y)
        for f in ("ids", "perm", "seg", "uid"):
            assert getattr(gx, f).dtype == getattr(gy, f).dtype
            assert np.array_equal(getattr(gx, f), getattr(gy, f)), f
        assert gx.lengths.sum() == len(gx.ids) and np.array_equal(gx.lengths, np.bincount(gx.seg, minlength=len(gx.uid)))
    assert {x.nodes_per_session for x in ours} <= set(port.DEFAULT_BUCKETS)


def test_collate_pads_truncates_and_masks_like_the_jax_packages():
    samples = [
        {"nodes": np.array([3, 5, 9, 11], np.int32), "edge_src": np.array([0, 1, 3], np.int32),
         "edge_dst": np.array([1, 2, 0], np.int32), "target": 7, "negatives": np.array([1, 2, 4], np.int32)},
        None,
        {"nodes": np.array([2], np.int32), "edge_src": np.zeros(0, np.int32), "edge_dst": np.zeros(0, np.int32),
         "target": 8, "negatives": np.array([6, 6, 6], np.int32)},
    ]
    got, want = port.collate(samples, 3, 3), ref.collate(samples, 3, 3)  # bucket 3 truncates node 11
    for f in BATCH_FIELDS:
        assert np.array_equal(getattr(got, f).numpy(), getattr(want, f)), f
    assert got.sample_mask.tolist() == [True, False, True] and got.num_nodes.tolist() == [3, 0, 1]


def test_grad_index_buckets_sentinel_tail_and_constants():
    assert port.UNIQUE_BUCKETS == ref.UNIQUE_BUCKETS and port.DEFAULT_BUCKETS == ref.DEFAULT_BUCKETS
    ids = np.random.default_rng(0).integers(0, 3000, 5000)
    gx, gy = port.make_grad_index_from_ids(ids), ref.make_grad_index_from_ids(ids)
    for f in ("ids", "perm", "seg", "uid"):
        assert np.array_equal(getattr(gx, f), getattr(gy, f))
    n = len(np.unique(ids))
    assert len(gx.uid) == 4096 and np.all(gx.uid[n:] == port.UID_SENTINEL) and np.all(gx.lengths[n:] == 0)
    assert np.all(np.diff(gx.uid[:n].astype(np.int64)) > 0)
    small = port.make_grad_index_from_ids(np.array([4, 4, 2]))
    assert len(small.uid) == 3 and small.uid.tolist()[:2] == [2, 4]


def test_to_device_moves_batches_indexes_and_pairs_and_serving_batches_stay_light():
    _, b, _, _ = _datasets(seed=5)
    batch = next(port.iterate_batches(b, 8))
    gidx = port.make_grad_index(batch)
    moved, midx = port.to_device((batch, gidx), "cpu")
    assert isinstance(midx, port.GradIndex) and all(isinstance(t, torch.Tensor) for t in midx)
    assert midx.uid.dtype == torch.int32 and midx.lengths.dtype == torch.int64
    assert torch.equal(moved.adj, batch.adj) and torch.equal(midx.perm, torch.from_numpy(gidx.perm))
    serving = port.SessionBatch(batch.node_ids, batch.node_mask, batch.adj, batch.num_nodes)
    assert serving.targets is None and port.to_device(serving, "cpu").negatives is None
    assert serving.to("cpu").sample_mask is None
    with pytest.raises(TypeError):
        port.to_device([batch], "cpu")


def test_engines_and_bucket_extension():
    _, b, _, edges = _datasets(seed=6)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        next(port.iterate_batches(b, 8, engine="native"))
    with pytest.raises(ValueError, match="Unknown batching engine"):
        next(port.iterate_batches(b, 8, engine="gpu"))
    assert len(list(port.iterate_batches(b, 8, engine="auto"))) == len(list(port.iterate_batches(b, 8)))
    sid, ts, item, _ = _corpus(seed=6, max_len=90)
    long = port.SessionDataset((sid, ts, item), edges, max_session_length=80)
    assert max(x.nodes_per_session for x in port.iterate_batches(long, 8)) <= 80
