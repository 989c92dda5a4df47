"""The bit-packed adjacency of the port against the JAX package's.

Towards any device but the CPU a batch's bool adjacency [B, N, N] travels as
``np.packbits`` rows [B, N, ceil(N / 8)] uint8 (most significant bit first),
and the models read it back through ``SessionBatch.dense_adj`` or, kernel 1,
as it is. Everything here is integer or boolean data made from a seed, so
every comparison is EQUAL: the packed bytes against the JAX ``pack_adj`` and
``np.packbits`` (the C++ library's pack included, on batches of the JAX
engine), the unpacked adjacency against the JAX ``dense_adj``, and the plain
attention and the three model families fed the packed batch against the same
fed the bool one (the same operations on the same mask). CPU batches stay
bool; a non-CPU device is the ``meta`` device, which takes the copy without
a card. The kernels' packed route is held on the card in
``tests/test_torch_kernels_on_card.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch.data import batching as port
from gat_recommendation_torch.data import native
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.ops.session_attention import session_attention, session_attention_reference
from gat_recommendation_tpu.data import batching as ref
from gat_recommendation_tpu.data import native as ref_native

torch.set_num_threads(1)

FIELDS = ("node_ids", "node_mask", "adj", "num_nodes", "targets", "negatives", "sample_mask")


def _datasets(seed=0, sessions=300, items=120):
    """A corpus that fills every node bucket (sessions up to 60 events over
    a dense graph), as both packages' datasets."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.geometric(0.06, sessions) + 2, 3, 60)
    total = int(lengths.sum())
    sid = np.repeat(np.arange(sessions) + 10, lengths)
    ts = rng.integers(0, 1000, total)
    item = rng.integers(1, items, total)
    ei = rng.integers(1, items - 1, 12 * items)
    ej = np.minimum(ei + rng.integers(1, 30, 12 * items), items - 1)
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": item, "event": "view"})
    return ref.SessionDataset(df, (ei, ej)), port.SessionDataset((sid, ts, item), (ei, ej))


@pytest.fixture(scope="module")
def batches():
    """Pairs (JAX batch, port batch) of the numpy engines, one epoch at batch 16."""
    a, b = _datasets()
    pairs = list(zip(ref.iterate_batches(a, 16, shuffle=True, seed=3, engine="numpy"),
                     port.iterate_batches(b, 16, shuffle=True, seed=3, engine="numpy")))
    assert {p.nodes_per_session for _, p in pairs} == set(port.DEFAULT_BUCKETS)
    return pairs


def test_pack_adj_equals_the_jax_packages_bit_for_bit(batches):
    for want, got in batches:
        packed = ref.pack_adj(want).adj
        mine = port.pack_adj(got)
        n = got.nodes_per_session
        assert mine.adj.dtype == torch.uint8 and mine.adj.shape == (16, n, (n + 7) // 8)
        np.testing.assert_array_equal(mine.adj.numpy(), packed)
        for plain in (native.pack_bits(got.adj.numpy()), np.packbits(got.adj.numpy(), axis=-1)):
            np.testing.assert_array_equal(plain, packed)
        assert mine.adj_packed and not got.adj_packed
        for f in FIELDS[:2] + FIELDS[3:]:  # the other fields go as they are
            assert getattr(mine, f) is getattr(got, f), f
        assert port.pack_adj(mine) is mine  # a packed batch stays as it is


def test_dense_adj_unpacks_what_the_jax_dense_adj_unpacks(batches):
    for want, got in batches:
        packed = port.pack_adj(got)
        jax_batch = dataclasses.replace(ref.pack_adj(want), adj=jnp.asarray(ref.pack_adj(want).adj),
                                        node_ids=jnp.asarray(want.node_ids))
        np.testing.assert_array_equal(packed.dense_adj().numpy(), np.asarray(jax_batch.dense_adj()))
        assert packed.dense_adj().dtype == torch.bool
        assert torch.equal(packed.dense_adj(), got.adj) and got.dense_adj() is got.adj


def test_the_cpp_pack_equals_np_packbits_on_the_jax_engines_batches():
    a, _ = _datasets(seed=4)
    engine = "native" if ref_native.available() else "numpy"  # the JAX C++ engine where it builds
    rng = np.random.default_rng(5)
    for batch in ref.iterate_batches(a, 32, shuffle=True, seed=1, engine=engine):
        adj = np.asarray(batch.adj)
        np.testing.assert_array_equal(native.pack_bits(adj), np.packbits(adj, axis=-1))
    for shape in ((3, 7, 13), (2, 1, 1), (4, 2, 64), (5, 9, 0)):  # off a multiple of 8, and edge widths
        adj = rng.random(shape) < 0.5
        np.testing.assert_array_equal(native.pack_bits(adj), np.packbits(adj, axis=-1))


def test_to_device_packs_towards_a_device_and_not_towards_the_cpu(batches):
    _, got = batches[-1]
    gidx = port.make_grad_index(got)
    assert port.worth_packing("meta") and port.worth_packing(torch.device("cuda", 0))
    assert not port.worth_packing("cpu")
    on_cpu, _ = port.to_device((got, gidx), "cpu")
    assert on_cpu.adj.dtype == torch.bool and torch.equal(on_cpu.adj, got.adj)
    moved, midx = port.to_device((got, gidx), "meta")
    n = got.nodes_per_session
    assert moved.adj.device.type == "meta" and moved.adj.dtype == torch.uint8
    assert moved.adj.shape == (16, n, (n + 7) // 8) and moved.adj_packed
    assert moved.node_ids.shape == got.node_ids.shape and isinstance(midx, port.GradIndex)
    serving = port.SessionBatch(got.node_ids, got.node_mask, got.adj, got.num_nodes)
    assert port.to_device(serving, "meta").adj_packed
    # The host batch is left as it was.
    assert got.adj.dtype == torch.bool and got.adj.shape == (16, n, n)


def test_prefetch_to_device_packs_on_its_way(batches):
    items = [p for _, p in batches[:4]]
    moved = list(port.prefetch_to_device(iter(items), device="meta", transfer_workers=2))
    assert [m.adj.shape for m in moved] == [(16, b.nodes_per_session, (b.nodes_per_session + 7) // 8)
                                             for b in items]
    assert all(m.adj_packed for m in moved)


def test_the_chained_step_takes_stacked_packed_rows(batches):
    """A group stacked on the host and copied goes as [C, B, N, ceil(N / 8)];
    stacking packed batches gives the same buffers, and each slot reads as its
    batch."""
    group = [p for _, p in batches if p.nodes_per_session == 56][:3]
    assert len(group) == 3
    stacked = port.stack_batches(group)
    moved = port.to_device(stacked, "meta")
    assert moved.adj.shape == (3, 16, 56, 7) and moved.adj.dtype == torch.uint8 and moved.adj_packed
    host = port.pack_adj(stacked)
    assert torch.equal(host.adj, port.stack_batches([port.pack_adj(b) for b in group]).adj)
    for i, b in enumerate(group):
        slot = port.SessionBatch(*(t[i] for t in (host.node_ids, host.node_mask, host.adj, host.num_nodes)))
        assert slot.adj_packed and torch.equal(slot.dense_adj(), b.adj)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_attention_fed_the_packed_rows_equals_it_fed_the_bool_adjacency(batches, dropout_p):
    rng = np.random.default_rng(6)
    for _, got in batches[::3]:
        B, N = got.batch_size, got.nodes_per_session
        q, k, v = (torch.from_numpy(rng.standard_normal((B, N, 32)).astype(np.float32)) for _ in range(3))
        packed = port.pack_adj(got)
        want = session_attention_reference(q, k, v, got.adj, 2, dropout_p, 9)
        assert torch.equal(session_attention_reference(q, k, v, packed.dense_adj(), 2, dropout_p, 9), want)
        assert torch.equal(session_attention_reference(q, k, v, packed.adj, 2, dropout_p, 9, packed=True), want)
        assert torch.equal(session_attention(q, k, v, packed.adj, 2, dropout_p, 9, packed=True), want)


@pytest.mark.parametrize("name,fields", [("graph_transformer_optimized", {}), ("gat", {}),
                                         ("graphsage", {"aggregator": "mean"}),
                                         ("graphsage", {"aggregator": "max"})])
def test_every_model_reads_the_packed_batch_as_the_bool_one(batches, name, fields):
    gen = torch.Generator().manual_seed(0)
    model = create_model(name, 128, device="cpu", generator=gen, embedding_dim=16, hidden_dim=16, dropout=0.1,
                         **fields)
    for _, got in batches[::4]:
        packed = port.pack_adj(got)
        model.train()
        assert torch.equal(model(packed, seed=5), model(got, seed=5))
        model.eval()
        assert torch.equal(model(packed), model(got))
