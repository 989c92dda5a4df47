"""The port's ranking losses and metrics vs the JAX package's.

Same numpy-seeded inputs through both; every loss, its aux entries and its
embedding-direct twin within 1e-6 (float32, reduction order only); gradients
with respect to the session embeddings within 1e-6 too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch.train import losses as port
from gat_recommendation_torch.train import metrics as port_metrics
from gat_recommendation_tpu.train import losses as ref
from gat_recommendation_tpu.train import metrics as ref_metrics

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed=0, B=12, K=5, D=16, V=80, masked=True):
    rng = np.random.default_rng(seed)
    sess = rng.standard_normal((B, D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    targets = rng.integers(1, V, B).astype(np.int32)
    negatives = rng.integers(1, V, (B, K)).astype(np.int32)
    mask = rng.random(B) < 0.7 if masked else None
    return sess, targets, negatives, table, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [("bpr", {}), ("listwise", {"temperature": 0.7}), ("dual", {"alpha": 0.6, "temperature": 1.3}),
         ("sampled_softmax", {"temperature": 2.0})]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("loss_type,kw", CASES)
def test_loss_and_its_embedding_twin_match_jax(loss_type, kw, masked):
    sess, targets, negatives, table, mask = _inputs(seed=len(loss_type), masked=masked)
    pfn, rfn = port.create_loss_function(loss_type, **kw), ref.create_loss_function(loss_type, **kw)
    got, got_aux = pfn(_t(sess), _t(targets), _t(negatives), _t(table), _t(mask))
    want, want_aux = rfn(_j(sess), _j(targets), _j(negatives), _j(table), _j(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(got_aux) == set(want_aux)
    for key in want_aux:
        np.testing.assert_allclose(got_aux[key].numpy(), np.asarray(want_aux[key]), **TOL)
    twin, _ = pfn.from_embeddings(_t(sess), _t(table[targets]), _t(table[negatives]), _t(mask))
    want_twin, _ = rfn.from_embeddings(_j(sess), _j(table[targets]), _j(table[negatives]), _j(mask))
    np.testing.assert_allclose(twin.numpy(), np.asarray(want_twin), **TOL)
    assert torch.equal(twin, got)


@pytest.mark.parametrize("name", ["bpr_loss", "listwise_loss", "dual_loss", "sampled_softmax_loss"])
def test_module_level_losses_match_jax_and_carry_their_twins(name):
    sess, targets, negatives, table, mask = _inputs(seed=3)
    got, _ = getattr(port, name)(_t(sess), _t(targets), _t(negatives), _t(table), _t(mask))
    want, _ = getattr(ref, name)(_j(sess), _j(targets), _j(negatives), _j(table), _j(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    twin, _ = getattr(port, name).from_embeddings(_t(sess), _t(table[targets]), _t(table[negatives]), _t(mask))
    assert torch.equal(twin, got)


@pytest.mark.parametrize("loss_type,kw", CASES[:3])
def test_loss_gradients_match_jax(loss_type, kw):
    sess, targets, negatives, table, mask = _inputs(seed=7)
    pfn, rfn = port.create_loss_function(loss_type, **kw), ref.create_loss_function(loss_type, **kw)
    s, e = _t(sess).requires_grad_(True), _t(table).requires_grad_(True)
    loss, _ = pfn(s, _t(targets), _t(negatives), e, _t(mask))
    gs, ge = torch.autograd.grad(loss, (s, e))
    ws, we = jax.grad(lambda a, b: rfn(a, _j(targets), _j(negatives), b, _j(mask))[0], argnums=(0, 1))(
        _j(sess), _j(table))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), **TOL)


def test_all_masked_batch_gives_zero_loss_and_unknown_type_raises():
    sess, targets, negatives, table, _ = _inputs()
    mask = np.zeros(len(sess), bool)
    loss, _ = port.dual_loss(_t(sess), _t(targets), _t(negatives), _t(table), _t(mask))
    assert loss.item() == 0.0
    with pytest.raises(ValueError, match="Unknown loss type"):
        port.create_loss_function("hinge")


@pytest.mark.parametrize("k", [1, 5, 10, 20])
def test_recall_and_ndcg_equal_the_jax_packages(k):
    rng = np.random.default_rng(k)
    preds = np.stack([rng.permutation(200)[:20] for _ in range(64)])
    targets = np.where(rng.random(64) < 0.5, preds[np.arange(64), rng.integers(0, 20, 64)], 999)
    assert port_metrics.compute_recall_at_k(preds, targets, k) == ref_metrics.compute_recall_at_k(preds, targets, k)
    assert port_metrics.compute_ndcg_at_k(preds, targets, k) == ref_metrics.compute_ndcg_at_k(preds, targets, k)
    strata = rng.integers(0, 3, 64)
    got = port_metrics.compute_stratified_metrics(preds, targets, strata)
    assert got == ref_metrics.compute_stratified_metrics(preds, targets, strata)
    empty = np.zeros((0, 20), int)
    assert port_metrics.compute_recall_at_k(empty, np.zeros(0, int), k) == 0.0
