"""Multi-process batch assembly of the port against the JAX package's, on the CPU.

The data ranks of a mesh each assemble their rows of every global batch:
``iterate_batches(process_index, process_count, with_global_meta,
with_global_ids)``. For the same dataset, seed and process, the port's local
batch and its ``GlobalBatchMeta`` must equal the JAX package's bit for bit,
with the numpy engine and the C++ engine, at 2 and 4 processes; the local
batches put together must equal the one-process batch, and the meta's ids the
one-process batch's id list. No spawn: each process's view is one call.
"""

import time

import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch.data import batching as port
from gat_recommendation_tpu.data import batching as ref
from gat_recommendation_tpu.data import native as ref_native

torch.set_num_threads(1)

FIELDS = ("node_ids", "node_mask", "adj", "num_nodes", "targets", "negatives", "sample_mask")
BATCH = 8


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX package's C++ engine, whose first build (``make -C native``)
    another test worker may still be running: the load is tried again until
    it has finished."""
    for _ in range(120):
        if ref_native.available():
            return ref_native
        ref_native._load_attempted = False
        time.sleep(1.0)
    pytest.fail("the JAX package's C++ engine did not build (make -C native)")


@pytest.fixture(scope="module")
def datasets():
    """~100 sessions over 104 items; sessions of every length, so that
    batches end short (padding slots) and the buckets 8, 16 and 32 fill."""
    rng = np.random.default_rng(3)
    lengths = np.clip(rng.geometric(0.15, 100) + 2, 3, 30)
    total = int(lengths.sum())
    sid, ts = np.repeat(np.arange(100), lengths), np.arange(total)
    items = rng.integers(1, 104, total)
    edges = (rng.integers(1, 104, 600), rng.integers(1, 104, 600))
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": items})
    return (ref.SessionDataset(df, edges, num_items=104),
            port.SessionDataset((sid, ts, items), edges, num_items=104))


def _assert_batch_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("engine", ["numpy", "native"])
@pytest.mark.parametrize("process_count", [2, 4])
def test_local_batches_and_global_metas_equal_the_jax_packages(datasets, jax_engine, engine, process_count):
    jax_ds, port_ds = datasets
    whole = list(port.iterate_batches(port_ds, BATCH, shuffle=True, seed=5, engine=engine))
    per_process = []
    for p in range(process_count):
        kw = dict(shuffle=True, seed=5, engine=engine, process_index=p, process_count=process_count,
                  with_global_ids=True)
        got = list(port.iterate_batches(port_ds, BATCH, **kw))
        want = list(ref.iterate_batches(jax_ds, BATCH, **kw))
        assert len(got) == len(want) == len(whole)
        for (batch, meta), (ref_batch, ref_meta) in zip(got, want):
            assert isinstance(meta, port.GlobalBatchMeta)
            _assert_batch_equal(batch, ref_batch)
            for f in ("targets", "sample_mask", "ids"):
                np.testing.assert_array_equal(getattr(meta, f), np.asarray(getattr(ref_meta, f)), err_msg=f)
        per_process.append(got)
    # The local rows put together are the one-process batch; every process
    # holds the same meta, whose ids are the one-process batch's.
    for i, batch in enumerate(whole):
        rows = [per_process[p][i][0] for p in range(process_count)]
        for f in FIELDS:
            np.testing.assert_array_equal(np.concatenate([np.asarray(getattr(r, f)) for r in rows]),
                                          np.asarray(getattr(batch, f)), err_msg=f)
        metas = [per_process[p][i][1] for p in range(process_count)]
        np.testing.assert_array_equal(metas[0].ids, port.make_grad_index(batch).ids)
        for m in metas[1:]:
            np.testing.assert_array_equal(m.ids, metas[0].ids)
            np.testing.assert_array_equal(m.targets, metas[0].targets)
    assert any(not batch.sample_mask.all() for batch in whole)  # short batches were met


def test_meta_without_ids_and_the_argument_checks(datasets):
    _, port_ds = datasets
    batch, meta = next(port.iterate_batches(port_ds, BATCH, engine="numpy", with_global_meta=True))
    assert meta.ids is None and meta.targets.shape == (BATCH,) and batch.batch_size == BATCH
    items = list(port.iterate_batches(port_ds, BATCH, engine="numpy", process_index=1, process_count=2))
    assert all(isinstance(it, tuple) and it[0].batch_size == BATCH // 2 for it in items)
    with pytest.raises(ValueError, match="divide"):
        next(port.iterate_batches(port_ds, BATCH, process_count=3))
    with pytest.raises(ValueError, match="process index"):
        next(port.iterate_batches(port_ds, BATCH, process_index=2, process_count=2))
    # One process without meta is the plain epoch.
    plain = next(port.iterate_batches(port_ds, BATCH, engine="numpy"))
    assert isinstance(plain, port.SessionBatch)


@pytest.mark.parametrize("pcount", [1, 2, 4])
def test_host_shard_is_the_jax_packages(pcount):
    from gat_recommendation_torch.parallel.distributed import host_shard
    from gat_recommendation_tpu.parallel.distributed import host_shard as jax_host_shard

    for chunk in (list(range(8)), list(range(5)), []):  # a full, a short and an empty global batch
        for p in range(pcount):
            assert host_shard(chunk, BATCH, p, pcount) == jax_host_shard(chunk, BATCH, p, pcount)
    with pytest.raises(ValueError, match="divide"):
        host_shard(list(range(8)), BATCH, 0, 3)
