"""The port's lazy catch-up AdamW (ops/lazy_adamw.py) vs the JAX package's.

The same numpy-seeded rows go through the JAX functions and the port's plain
versions (what the wrappers run on CPU tensors), with catch-up gaps m of 0, 1,
2, 5, 20, 63, 64 and 300 steps. Tolerances, float32 on both sides: weights
rtol 1e-6 / atol 1e-8, moments rtol 1e-6. Both follow the same expressions
in the same order; exp comes from two libraries and differs in the last bit
now and then (measured: 4.1e-7 relative on a caught-up weight, 1.7e-7 on a
moment). The wrappers are held to the JAX optimizer's own lazy methods
(``gather_catch_up``, ``update_sparse_lazy``) on the same state. bf16
moments with stochastic rounding draw other bits than the JAX package, so
they are held in distribution and for their keying.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch.data.batching import UID_SENTINEL
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.ops import lazy_adamw as la
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_tpu.ops import lazy_adamw as jla
from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

torch.set_num_threads(1)

HP = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5)
W_TOL = dict(rtol=1e-6, atol=1e-8)
M_TOL = dict(rtol=1e-6, atol=0)
GAPS = np.array([0, 1, 2, 5, 20, 63, 64, 300], np.int32)
LAST = np.array([0, 1, 3, 10, 40, 7, 100, 5], np.int32)


def _rows(rng, n, d):
    w = rng.normal(0, 0.05, (n, d)).astype(np.float32)
    mu = rng.normal(0, 0.01, (n, d)).astype(np.float32)
    nu = rng.gamma(2.0, 5e-5, (n, d)).astype(np.float32)  # realistic tiny nu
    return w, mu, nu


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _close(got, want, names=("w", "mu", "nu")):
    for g, w, name in zip(got, want, names):
        tol = W_TOL if name == "w" else M_TOL
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), err_msg=name, **tol)


def test_catch_up_matches_the_jax_package():
    w, mu, nu = _rows(np.random.default_rng(0), len(GAPS), 16)
    want = jla.catch_up(*map(jnp.asarray, (w, mu, nu, LAST, GAPS)), **HP)
    got = la.catch_up(*_t(w, mu, nu, LAST, GAPS), **HP)
    _close([g.numpy() for g in got], want)
    assert np.array_equal(got[0][0].numpy(), w[0]) and np.array_equal(got[1][0].numpy(), mu[0])  # m = 0


def test_catch_up_matches_stepped_zero_gradient_adamw():
    """The closed form against m literal steps of dense AdamW with zero
    gradient (the JAX package's oracle test, its tolerances), and the tail
    truncation beyond 64 terms within 5e-5."""
    w, mu, nu = _rows(np.random.default_rng(1), len(GAPS), 5)
    got = la.catch_up(*_t(w, mu, nu, LAST, GAPS), **HP)
    rows = []
    for i in range(len(GAPS)):
        r = _t(w[i:i + 1], mu[i:i + 1], nu[i:i + 1])
        for j in range(1, int(GAPS[i]) + 1):
            r = la.dense_reference_step(*r, torch.zeros(1, 5), int(LAST[i]) + j, **HP)
        rows.append(r)
    want = [torch.cat([r[k] for r in rows]).numpy() for k in range(3)]
    short = GAPS <= 63
    np.testing.assert_allclose(got[0].numpy()[short], want[0][short], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got[1].numpy()[short], want[1][short], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got[2].numpy()[short], want[2][short], rtol=1e-5, atol=1e-12)
    assert np.abs(got[0].numpy() - want[0]).max() < 5e-5


@pytest.mark.parametrize("count", [1, 2, 17, 1000])
def test_touched_update_matches_the_jax_package(count):
    rng = np.random.default_rng(2)
    w, mu, nu = _rows(rng, 6, 8)
    g = rng.normal(0, 0.1, (6, 8)).astype(np.float32)
    want = jla.touched_update(*map(jnp.asarray, (w, mu, nu, g)), jnp.asarray(count, jnp.int32), **HP)
    got = la.touched_update(*_t(w, mu, nu, g), count, **HP)
    _close([t.numpy() for t in got], want)
    oracle = jla.dense_reference_step(*map(jnp.asarray, (w, mu, nu, g)), count, **HP)
    _close([t.numpy() for t in la.dense_reference_step(*_t(w, mu, nu, g), count, **HP)], oracle)


def test_materialize_matches_the_jax_package_and_is_idempotent():
    rng = np.random.default_rng(3)
    w, mu, nu = _rows(rng, 8, 4)
    last = rng.integers(0, 20, 8).astype(np.int32)
    last[2] = 30  # already current
    want = jla.materialize_arrays(*map(jnp.asarray, (w, mu, nu, last)), jnp.asarray(30, jnp.int32), **HP)
    arrays = la.materialize_arrays(*_t(w, mu, nu, last), 30, **HP)
    _close([a.numpy() for a in arrays[:3]], want[:3])
    assert torch.all(arrays[3] == 30)
    # The in-place wrapper on CPU tensors, in chunks of 3 rows: the same bits.
    table, m, n, ls = _t(w, mu, nu, last)
    out = la.materialize(table, m, n, ls, 30, **HP)
    assert out[0] is table and out[3] is ls
    for a, b in zip(out, arrays):
        assert torch.equal(a, b)
    chunked = _t(w, mu, nu, last)
    la.materialize_reference(*chunked, 30, chunk_rows=3, **HP)
    assert all(torch.equal(a, b) for a, b in zip(chunked, out))
    assert torch.equal(table[2], torch.from_numpy(w[2]))  # m = 0 keeps the row's bits
    before = [t.clone() for t in out]
    la.materialize(*out, 30, **HP)
    assert all(torch.equal(a, b) for a, b in zip(out, before))


def _lazy_state(seed=4, rows=48, dim=8, n_real=13, slots=16, count=9):
    """A table mid-training: rows last written at various steps, a uid of
    n_real rows (row 0 among them) and a sentinel tail, summed gradients."""
    rng = np.random.default_rng(seed)
    w, mu, nu = _rows(rng, rows, dim)
    w[0] = mu[0] = nu[0] = 0.0
    last = rng.integers(0, count - 1, rows).astype(np.int32)
    ids = np.sort(np.concatenate([[0], rng.choice(np.arange(1, rows), n_real - 1, replace=False)]))
    uid = np.full(slots, UID_SENTINEL, np.int32)
    uid[:n_real] = ids
    summed = rng.normal(0, 0.1, (slots, dim)).astype(np.float32)
    summed[0] = 0.0
    summed[n_real:] = 0.0
    return w, mu, nu, last, uid, summed, count


def test_wrappers_match_the_jax_optimizers_lazy_methods():
    w, mu, nu, last, uid, summed, count = _lazy_state()
    jopt = JaxOptimizer(HP["lr"], HP["b1"], HP["b2"], HP["eps"], HP["weight_decay"], use_pallas=False, lazy=True)
    jstate = {"emb_mu": jnp.asarray(mu), "emb_nu": jnp.asarray(nu), "count": jnp.asarray(count - 1, jnp.int32),
              "rest": jopt._rest.init({}), "last_step": jnp.asarray(last)}
    jparams = {"item_embedding": jnp.asarray(w)}
    jrows = jopt.gather_catch_up(jparams, jstate, jnp.asarray(uid))
    jparams, jstate = jopt.update_sparse_lazy({}, jnp.asarray(uid), jnp.asarray(summed), *jrows, jstate, jparams)

    table, m, n, ls = _t(w, mu, nu, last)
    rows = la.gather_catch_up(table, m, n, ls, torch.from_numpy(uid), count, **HP)
    real = uid != UID_SENTINEL
    _close([r.numpy()[real] for r in rows], [np.asarray(r)[real] for r in jrows])
    assert all(torch.all(r[~torch.from_numpy(real)] == 0) for r in rows)  # sentinel slots: zeros
    out = la.touched_update_scatter(table, m, n, ls, torch.from_numpy(uid), *rows,
                                    torch.from_numpy(summed), count, **HP)
    assert out[0] is table and out[3] is ls
    _close([table.numpy(), m.numpy(), n.numpy()],
           [jparams["item_embedding"], jstate["emb_mu"], jstate["emb_nu"]])
    np.testing.assert_array_equal(ls.numpy(), np.asarray(jstate["last_step"]))
    untouched = np.setdiff1d(np.arange(len(w)), uid[real])
    for got, start in ((table, w), (m, mu), (n, nu), (ls, last)):
        assert np.array_equal(got.numpy()[untouched], start[untouched])  # bit-unchanged
    assert torch.all(ls[torch.from_numpy(uid[real]).long()] == count)
    assert torch.all(table[0] == 0) and torch.all(m[0] == 0)  # the padding row


def test_wrappers_check_their_arguments():
    w, mu, nu, last, uid, summed, count = _lazy_state()
    table, m, n, ls = _t(w, mu, nu, last)
    uid_t = torch.from_numpy(uid)
    for bad in (0, la.MAX_TAIL_TERMS + 1):
        with pytest.raises(ValueError, match="tail_terms"):
            la.gather_catch_up(table, m, n, ls, uid_t, count, tail_terms=bad, **HP)
        with pytest.raises(ValueError, match="tail_terms"):
            la.materialize(table, m, n, ls, count, tail_terms=bad, **HP)
    with pytest.raises(ValueError, match="cuda or cpu"):
        la.materialize(table.to("meta"), m.to("meta"), n.to("meta"), ls.to("meta"), count, **HP)
    rows = la.gather_catch_up(table, m, n, ls, uid_t, count, **HP)
    with pytest.raises(ValueError, match="count"):
        la.touched_update_scatter(table, m, n, ls, uid_t, *rows, torch.from_numpy(summed), 0, **HP)
    with pytest.raises(ValueError, match="bfloat16"):
        la.touched_update_scatter(table, m, n, ls, uid_t, *rows, torch.from_numpy(summed), count,
                                  stochastic_rounding=True, **HP)
    # What the kernels take, checked before a launch (the same checks on CPU tensors here).
    la._check_table("t", table, m, n, ls)
    la._check_rows("t", table, uid_t, w_c=rows[0], summed=torch.from_numpy(summed))
    for args, match in (((table.double(), m, n, ls), "float32"), ((table[:, :6].contiguous(), m, n, ls), "D % 4"),
                        ((table, m.half(), n, ls), "mu"), ((table, m, n[:4], ls), "nu"),
                        ((table, m, n, ls.long()), "last_step"),
                        ((table.t().contiguous().t(), m, n, ls), "contiguous")):
        with pytest.raises(ValueError, match=match):
            la._check_table("t", *args)
    for kw, match in ((dict(uid=uid_t.long()), "uid"), (dict(w_c=rows[0][:, :4]), "w_c"),
                      (dict(summed=torch.from_numpy(summed).double()), "summed")):
        with pytest.raises(ValueError, match=match):
            la._check_rows("t", table, kw.pop("uid", uid_t), **kw)


def test_lazy_optimizer_takes_sparse_steps_only_and_materialize_is_its_own():
    model = registry.create_model("graph_transformer_optimized", 50, embedding_dim=8, hidden_dim=8,
                                  laplacian_k=2, device="cpu")
    lazy, eager = FusedEmbeddingAdamW(1e-3, lazy=True), FusedEmbeddingAdamW(1e-3)
    lazy_state, eager_state = lazy.init(model), eager.init(model)
    assert lazy_state["last_step"].dtype == torch.int32 and lazy_state["last_step"].shape == (512,)
    assert "last_step" not in eager_state and not eager.lazy
    grads = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    with pytest.raises(ValueError, match="sparse"):
        lazy.update_full(grads, lazy_state, model)
    with pytest.raises(ValueError, match="lazy"):
        lazy.update_sparse({}, torch.zeros(1, dtype=torch.int32), torch.zeros(1, 8), lazy_state, model)
    before = model.item_embedding.detach().clone()
    eager_state["count"] = 5
    assert eager.materialize(model, eager_state) is eager_state  # a no-op
    assert torch.equal(model.item_embedding, before)


def _bf16_run(count, uid_keep=None, seed=5):
    """The touched update with bf16 moments (values bf16 holds) on the uid
    rows, or on the first uid_keep of them."""
    w, mu, nu, last, uid, summed, _ = _lazy_state(seed=seed, rows=256, dim=64, n_real=100, slots=128,
                                                  count=count)
    mu, nu = (torch.from_numpy(a).bfloat16().float().numpy() for a in (mu, nu))
    if uid_keep is not None:
        uid[uid_keep:] = UID_SENTINEL
        summed[uid_keep:] = 0.0
    out = {}
    for label, dtype, sr in (("f32", torch.float32, False), ("sr", torch.bfloat16, True)):
        table, m, n, ls = _t(w, mu, nu, last)
        m, n = m.to(dtype), n.to(dtype)
        rows = la.gather_catch_up(table, m, n, ls, torch.from_numpy(uid), count, **HP)
        la.touched_update_scatter(table, m, n, ls, torch.from_numpy(uid), *rows, torch.from_numpy(summed),
                                  count, stochastic_rounding=sr, **HP)
        out[label] = (m.float().numpy(), n.float().numpy())
    real = uid[uid != UID_SENTINEL]
    return out, real


def test_bf16_stochastic_lazy_moments_are_unbiased_and_keyed_by_count_row_and_buffer():
    runs, real = _bf16_run(7)
    exact, sr = runs["f32"][0][real], runs["sr"][0][real]
    err = sr - exact
    assert np.all(np.abs(err) <= np.abs(exact) * 2.0**-7 + 1e-30)  # a neighbouring bf16 value
    assert abs(err.mean()) < 4 * err.std() / np.sqrt(err.size)  # unbiased
    assert np.mean(sr != torch.from_numpy(exact).bfloat16().float().numpy()) > 0.2  # not round-to-nearest
    again, _ = _bf16_run(7)
    assert all(np.array_equal(a, b) for a, b in zip(again["sr"], runs["sr"]))  # a pure function of count
    other, _ = _bf16_run(8)
    assert not np.array_equal(other["sr"][0][real], sr)
    # Keyed by the row, not the slot: the same rows updated from a shorter uid draw the same bits.
    part, kept = _bf16_run(7, uid_keep=40)
    assert np.array_equal(part["sr"][0][kept], runs["sr"][0][kept])
    assert np.array_equal(part["sr"][1][kept], runs["sr"][1][kept])
    # mu and nu use different streams: the same value with the same decay
    # would round alike otherwise.
    decay = dict(HP, b1=0.3, b2=0.3)
    same = [torch.full((64, 8), 1.001).bfloat16() for _ in "mn"]
    la.materialize(torch.zeros(64, 8), *same, torch.zeros(64, dtype=torch.int32), 3,
                   stochastic_rounding=True, **decay)
    assert 0.2 < (same[0] != same[1]).float().mean() < 0.8
    # materialize keys by the global row: any chunking gives the same bits.
    chunked = [torch.full((64, 8), 1.001).bfloat16() for _ in "mn"]
    la.materialize_reference(torch.zeros(64, 8), *chunked, torch.zeros(64, dtype=torch.int32), 3,
                             stochastic_rounding=True, chunk_rows=5, **decay)
    assert torch.equal(chunked[0], same[0]) and torch.equal(chunked[1], same[1])
