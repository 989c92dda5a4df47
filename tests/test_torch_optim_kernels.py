"""The port's AdamW table updates and stochastic rounding vs the JAX package.

The same numpy-seeded inputs go through the JAX functions and the port's plain
versions (what the wrappers run on CPU tensors). The Pallas kernels run in
interpret mode, as in the JAX package's own tests.

Tolerance rtol 1e-6 / atol 1e-7, float32 on both sides: the port multiplies
by a float32 reciprocal bias correction, as the sparse Pallas kernel does,
where the XLA branch divides, and XLA contracts multiply-adds; a few ulp.
The bias corrections are float32 on both sides (a double-precision value
would differ by about 2e-5 relative at small counts). bf16 storage by
round-to-nearest must agree EXACTLY where the float32 moments do; with
stochastic rounding the two packages draw different bits, so that is held in
distribution only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch.data.batching import UID_SENTINEL
from gat_recommendation_torch.ops import embedding_adamw as ea
from gat_recommendation_torch.ops import rounding
from gat_recommendation_torch.ops import sparse_adamw as sp
from gat_recommendation_tpu.data.batching import UID_SENTINEL as JAX_UID_SENTINEL
from gat_recommendation_tpu.ops.pallas.embedding_adamw import (
    adamw_update_reference,
    fused_embedding_adamw,
)
from gat_recommendation_tpu.ops.pallas.sparse_adamw import TILE, fused_sparse_adamw, supports
from gat_recommendation_tpu.ops.rounding import stochastic_round_bf16 as jax_sr
from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

torch.set_num_threads(1)

HP = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5)
TOL = dict(rtol=1e-6, atol=1e-7)


def make_inputs(rows=4 * TILE, dim=128, n_unique=37, pad_to=64, seed=0, ids=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    mu = (rng.normal(size=(rows, dim)) * 0.01).astype(np.float32)
    nu = (np.abs(rng.normal(size=(rows, dim))) * 0.001).astype(np.float32)
    if ids is None:
        ids = np.sort(rng.choice(rows, n_unique, replace=False))
    ids = np.asarray(ids, np.int32)
    uid = np.full(pad_to, UID_SENTINEL, np.int32)
    uid[: len(ids)] = ids
    summed = rng.normal(size=(pad_to, dim)).astype(np.float32)
    summed[len(ids):] = 0.0
    if len(ids) and ids[0] == 0:
        summed[0] = 0.0  # caller contract: the padding row contributes nothing
    return table, mu, nu, uid, summed


def xla_branch(table, mu, nu, uid, summed, count, moment_dtype=None):
    """The JAX package's update_sparse without its Pallas kernel."""
    opt = JaxOptimizer(HP["lr"], HP["b1"], HP["b2"], HP["eps"], HP["weight_decay"],
                       use_pallas=False, moment_dtype=moment_dtype, stochastic_rounding=False)
    dt = moment_dtype or jnp.float32
    state = {"emb_mu": jnp.asarray(mu).astype(dt), "emb_nu": jnp.asarray(nu).astype(dt),
             "count": jnp.asarray(count - 1, jnp.int32), "rest": opt._rest.init({})}
    params, state = opt.update_sparse({}, jnp.asarray(uid), jnp.asarray(summed), state,
                                      {"item_embedding": jnp.asarray(table)})
    return params["item_embedding"], state["emb_mu"], state["emb_nu"]


def port_sparse(table, mu, nu, uid, summed, count, moment_dtype=torch.float32, **kw):
    t, m, n = (torch.from_numpy(a.copy()) for a in (table, mu, nu))
    m, n = m.to(moment_dtype), n.to(moment_dtype)
    out = sp.sparse_adamw(t, m, n, torch.from_numpy(uid), torch.from_numpy(summed), count, **HP, **kw)
    assert out[0] is t and out[1] is m and out[2] is n  # in place
    return [x.float().numpy() for x in out]


def assert_all_close(got, want):
    for g, w, name in zip(got, want, ("table", "mu", "nu")):
        np.testing.assert_allclose(g, np.asarray(w, dtype=np.float32), err_msg=name, **TOL)


def test_uid_sentinel_is_the_jax_packages():
    assert UID_SENTINEL == JAX_UID_SENTINEL and UID_SENTINEL.dtype == JAX_UID_SENTINEL.dtype


@pytest.mark.parametrize("seed,count", [(0, 1), (1, 3), (2, 10), (3, 1000)])
def test_sparse_adamw_matches_pallas_kernel_and_xla_branch(seed, count):
    args = make_inputs(seed=seed)
    got = port_sparse(*args, count)
    assert_all_close(got, fused_sparse_adamw(*map(jnp.asarray, args), count, **HP, interpret=True))
    assert_all_close(got, xla_branch(*args, count))


def test_sparse_adamw_all_slots_sentinel():
    table, mu, nu, _, summed = make_inputs()
    uid = np.full(64, UID_SENTINEL, np.int32)
    summed = np.zeros_like(summed)
    got = port_sparse(table, mu, nu, uid, summed, 3)
    assert_all_close(got, xla_branch(table, mu, nu, uid, summed, 3))
    assert_all_close(got, fused_sparse_adamw(*map(jnp.asarray, (table, mu, nu, uid, summed)), 3,
                                             **HP, interpret=True))


def test_sparse_adamw_uid_on_every_tile_boundary():
    rows = 4 * TILE
    rng = np.random.default_rng(2)
    ids = np.unique(np.concatenate([
        np.arange(0, rows, TILE), np.arange(TILE - 1, rows, TILE), rng.choice(rows, 50, replace=False),
    ]))
    table, _, _, uid, summed = make_inputs(rows=rows, pad_to=128, seed=2, ids=ids)
    zeros = np.zeros_like(table)
    got = port_sparse(table, zeros, zeros, uid, summed, 1)
    assert_all_close(got, xla_branch(table, zeros, zeros, uid, summed, 1))
    assert_all_close(got, fused_sparse_adamw(*map(jnp.asarray, (table, zeros, zeros, uid, summed)),
                                             1, **HP, interpret=True))


def test_sparse_adamw_row_offset_shard_equals_slice_of_global():
    table, mu, nu, uid, summed = make_inputs(seed=5)
    want = port_sparse(table, mu, nu, uid, summed, 3)
    for shard in range(2):
        lo, hi = shard * 2 * TILE, (shard + 1) * 2 * TILE
        got = port_sparse(table[lo:hi], mu[lo:hi], nu[lo:hi], uid, summed, 3, row_offset=lo)
        assert_all_close(got, [w[lo:hi] for w in want])
        jax_shard = fused_sparse_adamw(
            *map(jnp.asarray, (table[lo:hi], mu[lo:hi], nu[lo:hi], uid, summed)), 3,
            **HP, row_offset=lo, interpret=True)
        assert_all_close(got, jax_shard)


def test_sparse_adamw_takes_more_slots_and_rows_than_the_tpu_kernel():
    rows, dim, U = 3 * TILE + 17, 256, 16384  # rows not a tile multiple; summed = 16 MB
    assert not supports(rows, U, dim) and not supports(4 * TILE, U, dim)
    ids = np.sort(np.random.default_rng(7).choice(rows, 600, replace=False))
    args = make_inputs(rows=rows, dim=dim, pad_to=U, seed=7, ids=ids)
    assert_all_close(port_sparse(*args, 2), xla_branch(*args, 2))


def test_sparse_adamw_bf16_round_to_nearest_storage_is_exact():
    args = make_inputs(seed=8)
    # Moments that bf16 holds exactly, so both sides start from the same values.
    args = (args[0], *(np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                       for a in args[1:3]), *args[3:])
    f32 = port_sparse(*args, 4)
    got = port_sparse(*args, 4, moment_dtype=torch.bfloat16, stochastic_rounding=False)
    want = xla_branch(*args, 4, moment_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    for g, full, w in zip(got[1:], f32[1:], want[1:]):
        assert np.array_equal(g, torch.from_numpy(full).bfloat16().float().numpy())
        # The XLA side may differ by an ulp of float32 before it rounds, which can
        # flip a bf16 tie: all but a handful of entries must be identical.
        assert np.mean(g != np.asarray(w.astype(jnp.float32))) < 1e-3


@pytest.mark.parametrize("count", [1, 2, 5, 50])
def test_embedding_adamw_matches_reference_and_pallas_kernel(count):
    table, mu, nu, _, _ = make_inputs(rows=512, seed=count)
    grad = np.random.default_rng(count).normal(size=table.shape).astype(np.float32)
    grad[0] = 0.0
    t, m, n = (torch.from_numpy(a.copy()) for a in (table, mu, nu))
    out = ea.embedding_adamw(t, m, n, torch.from_numpy(grad), count, **HP)
    assert out[0] is t and out[1] is m and out[2] is n
    got = [x.numpy() for x in out]
    jargs = [jnp.asarray(a) for a in (table, mu, nu, grad)]
    assert_all_close(got, adamw_update_reference(*jargs, jnp.asarray(count, jnp.int32), **HP))
    assert_all_close(got, fused_embedding_adamw(*jargs, jnp.asarray(count, jnp.int32), **HP,
                                                interpret=True))


def test_embedding_adamw_bf16_storage_and_mixed_pair():
    table, mu, nu, _, _ = make_inputs(rows=512, seed=11)
    grad = np.random.default_rng(11).normal(size=table.shape).astype(np.float32)
    f32 = [torch.from_numpy(a.copy()) for a in (table, mu, nu)]
    ea.embedding_adamw(*f32, torch.from_numpy(grad), 3, **HP)
    mixed = [torch.from_numpy(table.copy()), torch.from_numpy(mu.copy()),
             torch.from_numpy(nu.copy()).bfloat16()]
    nu_start = mixed[2].float()
    ea.embedding_adamw(*mixed, torch.from_numpy(grad), 3, **HP)
    assert mixed[1].dtype == torch.float32 and mixed[2].dtype == torch.bfloat16
    assert torch.equal(mixed[1], f32[1])  # the f32 moment does not see the other's storage
    want_nu = HP["b2"] * nu_start + (1.0 - HP["b2"]) * torch.from_numpy(grad * grad)
    assert torch.equal(mixed[2], want_nu.bfloat16())


def test_stochastic_rounding_needs_a_bf16_moment_and_count_starts_at_one():
    args = make_inputs(rows=256, seed=1)
    with pytest.raises(ValueError, match="bfloat16"):
        port_sparse(*args, 1, stochastic_rounding=True)
    with pytest.raises(ValueError, match="count"):
        port_sparse(*args, 0)


def test_stochastic_rounding_is_exact_on_representable_values():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32)).bfloat16().float()
    bits = rounding.counter_hash(rounding.mix_seed(1, 2), torch.arange(4096))
    assert torch.equal(rounding.stochastic_round_bf16(x, bits).float(), x)
    key = jax.random.key(0)
    assert np.array_equal(np.asarray(jax_sr(jnp.asarray(x.numpy()), key).astype(jnp.float32)), x.numpy())


@pytest.mark.parametrize("value", [1.001, -3.14159, 1e-3 + 1e-6])
def test_stochastic_rounding_is_unbiased_like_the_jax_packages(value):
    """Mean of 4096 draws within 3 sigma of the value, in both packages; every
    draw is one of the two neighbouring bf16 values."""
    n = 4096
    x = torch.full((n,), value, dtype=torch.float32)
    lo = (x.view(torch.int32) & -65536).view(torch.float32)[0].item()
    ulp = 2.0 ** (np.floor(np.log2(abs(lo))) - 7)
    hi = lo + np.sign(value) * ulp
    frac = (value - lo) / (hi - lo)
    sigma = abs(hi - lo) * np.sqrt(frac * (1 - frac) / n)
    port = rounding.stochastic_round_bf16(
        x, rounding.counter_hash(rounding.mix_seed(7, 0), torch.arange(n))).float().numpy()
    ref = np.asarray(jax_sr(jnp.asarray(x.numpy()), jax.random.key(7)).astype(jnp.float32))
    for draws in (port, ref):
        assert set(np.unique(draws)) <= {np.float32(lo), np.float32(hi)}
        assert abs(draws.mean() - value) < 3 * sigma + 1e-9
    assert abs(port.mean() - ref.mean()) < 6 * sigma + 1e-9


def test_stochastic_moments_are_unbiased_and_keyed_by_count_row_and_buffer():
    rows, dim = 256, 64
    table, mu, nu, uid, summed = make_inputs(rows=rows, dim=dim, n_unique=20, pad_to=32, seed=4)
    mu, nu = (torch.from_numpy(a).bfloat16().float().numpy() for a in (mu, nu))  # bf16 holds them
    exact = port_sparse(table, mu, nu, uid, summed, 5)
    runs = {c: port_sparse(table, mu, nu, uid, summed, c, moment_dtype=torch.bfloat16,
                           stochastic_rounding=True) for c in (5, 6)}
    again = port_sparse(table, mu, nu, uid, summed, 5, moment_dtype=torch.bfloat16,
                        stochastic_rounding=True)
    assert all(np.array_equal(a, b) for a, b in zip(runs[5], again))  # a pure function of count
    err_mu = runs[5][1] - exact[1]
    assert np.all(np.abs(err_mu) <= np.abs(exact[1]) * 2.0**-7 + 1e-30)  # a neighbouring bf16 value
    assert abs(err_mu.mean()) < 4 * err_mu.std() / np.sqrt(err_mu.size)  # unbiased
    rne = torch.from_numpy(exact[1]).bfloat16().float().numpy()
    assert np.mean(runs[5][1] != rne) > 0.2  # and it is not round-to-nearest
    # A row shard draws the bits of its GLOBAL rows.
    lo = 128
    shard = port_sparse(table[lo:], mu[lo:], nu[lo:], uid, summed, 5, moment_dtype=torch.bfloat16,
                        stochastic_rounding=True, row_offset=lo)
    assert np.array_equal(shard[1], runs[5][1][lo:]) and np.array_equal(shard[2], runs[5][2][lo:])
    # mu and nu use different streams: the same value would round alike otherwise.
    same = [torch.from_numpy(table.copy()), *(torch.from_numpy(np.abs(mu)).bfloat16() for _ in "mn")]
    ea.embedding_adamw(*same, torch.zeros(rows, dim), 1, lr=0.0, b1=0.3, b2=0.3, stochastic_rounding=True)
    assert 0.2 < (same[1] != same[2]).float().mean() < 0.8


def test_counter_hash_matches_its_definition_and_covers_64_bit_counters():
    def mix32(x):
        x ^= x >> 15
        x = (x * 0x2C1B3C6D) & 0xFFFFFFFF
        x ^= x >> 12
        x = (x * 0x297A2D39) & 0xFFFFFFFF
        return x ^ (x >> 15)

    seed = rounding.mix_seed(42, 3, 1)
    assert 0 <= seed < 2**64 and seed != rounding.mix_seed(42, 3, 2)
    idx = [0, 1, 2**31 - 1, 2**32 - 1, 2**32, 2**40 + 12345, 2**62]
    got = rounding.counter_hash(seed, torch.tensor(idx, dtype=torch.int64)).tolist()
    want = [mix32(mix32((i & 0xFFFFFFFF) ^ (seed & 0xFFFFFFFF)) ^ (seed >> 32) ^ (i >> 32)) for i in idx]
    assert got == want
    h = rounding.counter_hash(seed, torch.arange(1 << 16))
    assert abs((h & 0xFFFF).float().mean().item() / 65535 - 0.5) < 0.01
    assert abs(((h >> 8) < round(0.9 * 2**24)).float().mean().item() - 0.9) < 0.005
