"""The port's C++ batch engine against the JAX package's, on the CPU.

Each package builds its own copy of the engine's source. Given the same
dataset arrays, session indices, batch seed and slot offset, the two must
assemble the SAME batch bit for bit (node ids, node mask, adjacency, node
counts, targets, negatives, sample mask), and build the same CSR graph.
``iterate_batches`` with default arguments must give the same epoch in both
packages: both default to ``engine="auto"``, which resolves to the C++ engine
where it builds. The port builds its library at first use under a file lock,
so concurrent first builds all load one complete library. An epoch of the
port's engine leaves no reference cycles.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch.data import batching as port
from gat_recommendation_torch.data import native as port_native
from gat_recommendation_tpu.data import batching as ref
from gat_recommendation_tpu.data import native as ref_native

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BATCH_FIELDS = ("node_ids", "node_mask", "adj", "num_nodes", "targets", "negatives", "sample_mask")
BUCKETS = (8, 16, 32, 56)


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX package's C++ engine. Its first build runs ``make -C native``;
    a test process that loads the library while another process is still
    writing it gives up for the session, so the load is tried again until the
    build has finished."""
    for _ in range(120):
        if ref_native.available():
            return ref_native
        ref_native._load_attempted = False
        time.sleep(1.0)
    pytest.fail("the JAX package's C++ engine did not build (make -C native)")


def _corpus(seed=0, sessions=160, items=300):
    """Sessions of 3 .. 50 events over a window of nearby items (every node
    bucket fills, the largest through sessions of 40 .. 50 unique items),
    edges between nearby items with duplicates."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.geometric(0.2, sessions) + 2, 3, 50)
    lengths[: sessions // 5] = rng.integers(40, 60, sessions // 5)  # truncated to the last 50
    total = int(lengths.sum())
    sid = np.repeat(rng.permutation(sessions) + 7, lengths)
    ts = rng.integers(0, 30, total)
    start = np.repeat(rng.integers(1, items - 90, sessions), lengths)
    item = start + rng.integers(0, 90, total)
    ei = rng.integers(1, items - 1, 4 * items)
    ej = np.minimum(ei + rng.integers(1, 9, 4 * items), items - 1)
    return sid, ts, item, (ei, ej)


def _datasets(seed=0, num_negatives=5):
    sid, ts, item, edges = _corpus(seed)
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": item, "event": "view"})
    return (ref.SessionDataset(df, edges, num_negatives=num_negatives),
            port.SessionDataset((sid, ts, item), edges, num_negatives=num_negatives))


def _assert_same_batch(want, got):
    for f in BATCH_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert isinstance(g, torch.Tensor) and g.dtype == torch.from_numpy(w).dtype, f
        assert np.array_equal(w, g.numpy()), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_csr_equals_the_jax_engines(jax_engine, seed):
    rng = np.random.default_rng(seed)
    V = 500
    ei = rng.integers(0, V, 3000)
    ej = rng.integers(0, V, 3000)
    ei[:50], ej[:50] = ei[50:100], ej[50:100]  # duplicate edges are kept
    indptr, indices = port_native.build_csr(ei, ej, V)
    want_ptr, want_idx = jax_engine.build_csr(ei, ej, V)
    assert indptr.dtype == np.int64 and indices.dtype == np.int32
    assert np.array_equal(indptr, want_ptr) and np.array_equal(indices, want_idx)
    numpy_csr = port.build_csr(ei, ej, V)  # the numpy engine's graph is the same
    assert np.array_equal(numpy_csr.indptr, indptr) and np.array_equal(numpy_csr.indices, indices)


@pytest.mark.parametrize("layout", ["full", "padded", "slot_offset", "truncated"])
@pytest.mark.parametrize("bucket_n", BUCKETS)
def test_assemble_batch_equals_the_jax_engines(jax_engine, bucket_n, layout):
    """Every bucket; a full batch, a padded tail, a nonzero slot offset (the
    negatives' stream is keyed by the global slot) and sessions with more
    unique items than the bucket holds (nodes and their edges cut)."""
    a, b = _datasets(seed=bucket_n)
    fits = [i for i in range(len(b)) if port.pick_bucket(int(b.unique_counts[i]), BUCKETS) == bucket_n]
    over = [i for i in range(len(b)) if b.unique_counts[i] > bucket_n] or fits
    batch_size = 16
    chunk = {"full": fits[:batch_size], "padded": fits[:5], "slot_offset": fits[:11],
             "truncated": over[:batch_size]}[layout]
    offset = 37 if layout == "slot_offset" else 0
    seed = port._native_batch_seed(bucket_n, 3)
    got = port_native.assemble_batch(b, chunk, batch_size, bucket_n, seed, slot_offset=offset)
    want = jax_engine.assemble_batch(a, chunk, batch_size, bucket_n, seed, slot_offset=offset)
    _assert_same_batch(want, got)
    assert int(got.sample_mask.sum()) == len(chunk) and got.node_ids.shape == (batch_size, bucket_n)
    assert int(got.num_nodes.max()) <= bucket_n and bool(got.adj.any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_negatives_follow_the_jax_engines_splitmix_stream(seed):
    """The JAX package's numpy mirror of the C++ negatives, slot by slot."""
    _, b = _datasets(seed=seed, num_negatives=7)
    chunk = list(range(3, 3 + 20))
    bs = port._native_batch_seed(seed, 5)
    got = port_native.assemble_batch(b, chunk, 24, 56, bs, slot_offset=64)
    for s, i in enumerate(chunk):
        items = b.session_items(i)
        want = ref._native_negatives(bs, 64 + s, items, b.num_items, 7)
        assert np.array_equal(got.negatives[s].numpy(), want)
        assert not set(want.tolist()) & set(items.tolist())
    assert torch.all(got.negatives[len(chunk):] == 0)


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 0), (True, 3), (True, 11)])
def test_default_epoch_equals_the_jax_default_epoch(jax_engine, shuffle, seed):
    a, b = _datasets(seed=seed + 20)
    assert ref._resolve_engine("auto") == port._resolve_engine("auto") == "native"
    want = list(ref.iterate_batches(a, 32, shuffle=shuffle, seed=seed))
    got = list(port.iterate_batches(b, 32, shuffle=shuffle, seed=seed))
    assert len(got) == len(want) and {x.nodes_per_session for x in got} == set(BUCKETS)
    for w, g in zip(want, got):
        _assert_same_batch(w, g)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_pooled_assembly_equals_inline_and_the_jax_pooled_epoch(jax_engine, engine, workers):
    """Assembly on a thread pool (a window of 2 * workers batches in flight,
    yielded in order) gives the epoch of workers=0, and the JAX package's
    pooled epoch, batch for batch."""
    a, b = _datasets(seed=30 + workers)
    inline = list(port.iterate_batches(b, 16, shuffle=True, seed=workers, engine=engine))
    pooled = list(port.iterate_batches(b, 16, shuffle=True, seed=workers, engine=engine, workers=workers))
    want = list(ref.iterate_batches(a, 16, shuffle=True, seed=workers, engine=engine, workers=workers))
    assert len(pooled) == len(inline) == len(want) > 2 * workers
    for w, x, y in zip(want, inline, pooled):
        _assert_same_batch(w, y)
        assert all(torch.equal(getattr(x, f), getattr(y, f)) for f in BATCH_FIELDS)


def test_an_abandoned_pooled_epoch_stops_assembling():
    _, b = _datasets(seed=5)
    epoch = port.iterate_batches(b, 8, engine="native", workers=3)
    first = next(epoch)
    epoch.close()  # the pool's pending batches are cancelled, its threads joined
    assert first.batch_size == 8 and first.nodes_per_session == BUCKETS[0]


@pytest.mark.parametrize("builds", [True, False])
def test_auto_resolves_as_in_the_jax_package(monkeypatch, builds):
    monkeypatch.setattr(port_native, "available", lambda: builds)
    monkeypatch.setattr(ref_native, "available", lambda: builds)
    assert port._resolve_engine("auto") == ref._resolve_engine("auto") == ("native" if builds else "numpy")
    for engine in ("numpy", "native"):
        assert port._resolve_engine(engine) == ref._resolve_engine(engine) == engine
    for resolve in (port._resolve_engine, ref._resolve_engine):
        with pytest.raises(ValueError, match="Unknown batching engine"):
            resolve("gpu")


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_and_numpy_engines_differ_only_in_the_negatives(shuffle):
    _, b = _datasets(seed=4)
    native = list(port.iterate_batches(b, 24, shuffle=shuffle, seed=2, engine="native"))
    numpy = list(port.iterate_batches(b, 24, shuffle=shuffle, seed=2, engine="numpy"))
    assert len(native) == len(numpy)
    for x, y in zip(native, numpy):
        for f in BATCH_FIELDS:
            if f != "negatives":
                assert torch.equal(getattr(x, f), getattr(y, f)), f
        for row, s in enumerate(x.sample_mask.nonzero().flatten().tolist()):
            assert s == row  # valid slots first, padding after
    assert not all(torch.equal(x.negatives, y.negatives) for x, y in zip(native, numpy))


@pytest.mark.parametrize("workers", [0, 2])
def test_the_native_engine_leaves_no_reference_cycles(workers):
    """An epoch of the C++ engine leaves nothing for the garbage collector:
    its pointers into the numpy arrays refer to no one (``a.ctypes.data_as``
    casts a pointer that refers to itself, two objects a call, and a full
    collection of such garbage, landing in a timed window, stalled it)."""
    import gc

    _, ds = _datasets()
    gc.collect()
    gc.disable()
    try:
        batches = list(port.iterate_batches(ds, 16, shuffle=True, seed=0, engine="native", workers=workers))
        port_native.build_csr(np.array([1, 2, 3]), np.array([2, 3, 1]), 5)
        found = gc.collect()
    finally:
        gc.enable()
    assert len(batches) > 5 and found == 0


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")  # a "compiler" that exits 1
    with pytest.raises(RuntimeError, match="failed to build the C\\+\\+ batch engine"):
        port_native.build(tmp_path)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


_BUILD_AND_LOAD = """
import ctypes, sys
from gat_recommendation_torch.data import native
path = native.build(sys.argv[1])
ctypes.CDLL(str(path)).build_csr
print(path)
"""


def _one_library(build_dir: Path, paths: list) -> None:
    assert len(paths) == 6 and len(set(paths)) == 1
    assert Path(paths[0]) == port_native.library_path(build_dir) and Path(paths[0]).exists()
    assert [p.name for p in build_dir.glob("*.so")] == [Path(paths[0]).name]
    assert not list(build_dir.glob("*.tmp"))


def test_six_concurrent_first_builds_in_processes_load_one_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    _one_library(tmp_path, [out.strip() for out, _ in outs])


def test_six_concurrent_first_builds_in_threads_load_one_library(tmp_path):
    paths, errors = [], []

    def build():
        try:
            paths.append(str(port_native.build(tmp_path)))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    _one_library(tmp_path, paths)
