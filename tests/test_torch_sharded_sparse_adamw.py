"""B1, kernel 3 on each row shard of the table: the port's twin against the JAX kernel.

``ops/sparse_adamw.py::sharded_sparse_adamw`` on the CPU runs its plain twin,
``sharded_sparse_adamw_reference``: ``sparse_adamw_reference`` at the
shard's row offset. Held, on the same seeded inputs, against
``ops/pallas/sparse_adamw.py::sharded_fused_sparse_adamw`` on the conftest's
(4, 2) CPU mesh in interpret mode, and shard by shard against
``fused_sparse_adamw(row_offset=)``, as ``tests/test_sparse_adamw_kernel.py``
holds the JAX kernel: float32 table and moments within rtol 1e-6 / atol 1e-7
(the AdamW tolerance); bfloat16 moments stored by rounding to nearest, the
table the same and each moment within one bfloat16 step (a float32 ulp
before the store can move a value across a rounding midpoint). The JAX
kernel's stochastic rounding draws from the TPU's hardware generator, which
has no CPU rule even in interpret mode, so bfloat16 with stochastic rounding
is held against what the JAX package runs without its kernel
(``FusedEmbeddingAdamW.update_sparse``'s XLA branch): the table within the
AdamW tolerance, each moment one of the two bfloat16 neighbours of the
reference's (the packages draw their rounding bits from different streams).
The shards put together equal one unsharded call bit for bit at 1, 2, 4 and
8 shards, float32 and bfloat16 with stochastic rounding: the rounding
counters are global rows. No spawn: the shards are views of one table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch.ops import sparse_adamw as port
from gat_recommendation_tpu.data.batching import UID_SENTINEL
from gat_recommendation_tpu.ops.pallas import sparse_adamw as ref
from gat_recommendation_tpu.parallel.mesh import make_mesh
from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

torch.set_num_threads(1)

HP = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5)
TOL = dict(rtol=1e-6, atol=1e-7)
ROWS, DIM, COUNT = 4 * ref.TILE, 128, 3


def _inputs(seed: int, n_unique: int = 37, pad_to: int = 64):
    """The JAX kernel test's inputs (``make_inputs``): a table of 4 tiles,
    37 unique touched rows in 64 slots, the sentinel tail zero."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    mu = (rng.normal(size=(ROWS, DIM)) * 0.01).astype(np.float32)
    nu = (np.abs(rng.normal(size=(ROWS, DIM))) * 0.001).astype(np.float32)
    ids = np.sort(rng.choice(ROWS, n_unique, replace=False)).astype(np.int32)
    uid = np.full(pad_to, UID_SENTINEL, np.int32)
    uid[:n_unique] = ids
    summed = rng.normal(size=(pad_to, DIM)).astype(np.float32)
    summed[n_unique:] = 0.0
    if ids[0] == 0:
        summed[0] = 0.0
    return table, mu, nu, uid, summed


def _bf16(a: np.ndarray) -> np.ndarray:
    """`a` rounded to bfloat16, as float32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


MOMENTS = ["f32", "bf16", "bf16+sr"]  # float32; bfloat16 rounded to nearest; with stochastic rounding


def _xla_branch(table, mu, nu, uid, summed):
    """The JAX package's update_sparse without its kernel, bfloat16 moments
    with stochastic rounding."""
    opt = JaxOptimizer(HP["lr"], HP["b1"], HP["b2"], HP["eps"], HP["weight_decay"], use_pallas=False,
                       moment_dtype=jnp.bfloat16, stochastic_rounding=True)
    state = {"emb_mu": jnp.asarray(mu, jnp.bfloat16), "emb_nu": jnp.asarray(nu, jnp.bfloat16),
             "count": jnp.asarray(COUNT - 1, jnp.int32), "rest": opt._rest.init({})}
    params, state = opt.update_sparse({}, jnp.asarray(uid), jnp.asarray(summed), state,
                                      {"item_embedding": jnp.asarray(table)})
    return params["item_embedding"], state["emb_mu"], state["emb_nu"]


def _port_shards(table, mu, nu, uid, summed, n_shards: int, moments: str):
    """B1's twin on each of `n_shards` row blocks (views of one table); the whole table after."""
    stochastic = moments == "bf16+sr"
    dtype = torch.float32 if moments == "f32" else torch.bfloat16
    t = torch.from_numpy(table.copy())
    m, n = (torch.from_numpy(a.copy()).to(dtype) for a in (mu, nu))
    per = ROWS // n_shards
    before = port.sharded_sparse_adamw.launches
    for s in range(n_shards):
        rows = slice(s * per, (s + 1) * per)
        port.sharded_sparse_adamw(t[rows], m[rows], n[rows], torch.from_numpy(uid), torch.from_numpy(summed), COUNT,
                                  shard=s, n_shards=n_shards, stochastic_rounding=stochastic, **HP)
    assert port.sharded_sparse_adamw.launches == before  # the plain twin on the CPU: no kernel
    return t, m, n


def _assert_moment_close(got: torch.Tensor, want, moments: str, name: str) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if moments == "f32":
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        return
    # Neighbours of (nearly) the same float32 value: at most one bfloat16 step apart.
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step * (1 + 1e-6)), name


def _reference(table, mu, nu, uid, summed, moments: str, mesh=None, shard=None):
    """The JAX side: the sharded kernel on `mesh`, or the kernel on row block
    `shard` = (lo, hi) at its row offset; for bf16+sr the XLA branch."""
    if moments == "bf16+sr":
        want = _xla_branch(table, mu, nu, uid, summed)
        return want if shard is None else [w[shard[0]:shard[1]] for w in want]
    dtype = jnp.float32 if moments == "f32" else jnp.bfloat16
    if shard is None:
        return ref.sharded_fused_sparse_adamw(
            jnp.asarray(table), jnp.asarray(mu, dtype), jnp.asarray(nu, dtype), jnp.asarray(uid),
            jnp.asarray(summed), jnp.asarray(COUNT), mesh, interpret=True, **HP)
    lo, hi = shard
    return ref.fused_sparse_adamw(
        jnp.asarray(table[lo:hi]), jnp.asarray(mu[lo:hi], dtype), jnp.asarray(nu[lo:hi], dtype), jnp.asarray(uid),
        jnp.asarray(summed), COUNT, row_offset=lo, interpret=True, **HP)


@pytest.mark.parametrize("moments", MOMENTS)
def test_twin_equals_the_jax_sharded_kernel_on_a_4x2_mesh(moments):
    table, mu, nu, uid, summed = _inputs(6)
    if moments != "f32":
        mu, nu = _bf16(mu), _bf16(nu)
    mesh = make_mesh(n_data=4, n_model=2, devices=jax.devices()[:8])
    want = _reference(table, mu, nu, uid, summed, moments, mesh=mesh)
    got = _port_shards(table, mu, nu, uid, summed, 2, moments)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w, name in zip(got[1:], want[1:], ("mu", "nu")):
        _assert_moment_close(g, w, moments, name)


@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_each_shard_equals_the_jax_kernel_at_its_row_offset(n_shards, moments):
    table, mu, nu, uid, summed = _inputs(5)
    if moments != "f32":
        mu, nu = _bf16(mu), _bf16(nu)
    got = _port_shards(table, mu, nu, uid, summed, n_shards, moments)
    per = ROWS // n_shards
    for s in range(n_shards):
        lo, hi = s * per, (s + 1) * per
        want = _reference(table, mu, nu, uid, summed, moments, shard=(lo, hi))
        np.testing.assert_allclose(got[0][lo:hi].numpy(), np.asarray(want[0]), **TOL, err_msg=f"shard {s}")
        for g, w, name in zip(got[1:], want[1:], ("mu", "nu")):
            _assert_moment_close(g[lo:hi], w, moments, f"shard {s} {name}")


@pytest.mark.parametrize("moments", ["f32", "bf16+sr"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_the_shards_put_together_equal_one_unsharded_call_bit_for_bit(n_shards, moments):
    stochastic = moments == "bf16+sr"
    table, mu, nu, uid, summed = _inputs(7, n_unique=200, pad_to=256)
    if stochastic:
        mu, nu = _bf16(mu), _bf16(nu)
    got = _port_shards(table, mu, nu, uid, summed, n_shards, moments)
    dtype = torch.bfloat16 if stochastic else torch.float32
    whole = port.sparse_adamw_reference(
        torch.from_numpy(table.copy()), *(torch.from_numpy(a.copy()).to(dtype) for a in (mu, nu)),
        torch.from_numpy(uid), torch.from_numpy(summed), COUNT, stochastic_rounding=stochastic, **HP)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)


def test_supports_is_the_jax_packages_routing_test():
    for rows in (ROWS, ROWS + 1, 3 * ref.TILE, 467_456):
        for slots in (1024, 8192, 16_384):
            for n_shards in (1, 2, 3, 4, 8):
                assert port.supports(rows, slots, 256, n_shards) == ref.supports(rows, slots, 256, n_shards)


def test_a_shard_outside_the_mesh_raises():
    table, mu, nu, uid, summed = _inputs(1)
    args = (torch.from_numpy(table[:512]), torch.from_numpy(mu[:512]), torch.from_numpy(nu[:512]),
            torch.from_numpy(uid), torch.from_numpy(summed), COUNT)
    with pytest.raises(ValueError, match="shard 2 of 2"):
        port.sharded_sparse_adamw(*args, shard=2, n_shards=2, **HP)
