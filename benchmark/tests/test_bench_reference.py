"""The reference against the program on the CPU at a tiny size: the frozen
copies (corpus, edges, seeds and bits, batches), the check of a whole run,
the TF32 control, and a run with the timed path broken underneath for each
fault the cell can have, which has to come out not correct. The control at
the cells' own size runs on the card (``cuda`` marker)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import corpus, harness
from benchmark.reference import batches as rb
from benchmark.reference import hashing
from benchmark.reference import model as rm
from benchmark.tests import tiny

from gat_recommendation_torch import bench
from gat_recommendation_torch.data import batching
from gat_recommendation_torch.data.graph import build_co_event_graph
from gat_recommendation_torch.ops import rounding


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_frozen_corpus_is_the_programs(seed):
    got = corpus.corpus_columns(700, 5000, seed)
    want = bench.corpus_columns(700, 5000, seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_edges_are_the_programs_pairs():
    sid, ts, items = corpus.corpus_columns(400, 3000, 3)
    edges, _ = build_co_event_graph((sid, ts, items, "view"))
    i, j = corpus.co_event_edges(sid, ts, items, 5)
    assert sorted(zip(i.tolist(), j.tolist())) == sorted(zip(edges["item_i"].tolist(), edges["item_j"].tolist()))


def test_seeds_and_bits_are_the_programs():
    for values in [(1,), (2**31 + 5, 3, 7), (2**64 - 1, 0)]:
        assert hashing.mix_seed(*values) == rounding.mix_seed(*values)
    idx = torch.arange(0, 1 << 12, dtype=torch.int64) * 977 + (1 << 33)
    seed = rounding.mix_seed(9, 1, 0)
    assert torch.equal(hashing.counter_hash(seed, idx), rounding.counter_hash(seed, idx))
    assert torch.equal(hashing.keep_mask((4, 8, 8), 0.1, seed, "cpu"), rounding.keep_mask((4, 8, 8), 0.1, seed, "cpu"))
    assert hashing.keep_scale(0.1) == rounding.keep_scale(0.1)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -1 - 3 * 2**-11, 3.14159])
    assert rm.tf32_round(x).tolist() == [1.0, 1.0, 1 + 2**-9, -1 - 2**-9, 3.140625]


@pytest.mark.parametrize("shuffle,epoch_seed", [(True, 2**31 + 1), (False, 0)])
def test_batches_are_the_programs(shuffle, epoch_seed):
    c = tiny.cell("gt_ffn.train_lazy_b512")
    cfg, traffic = c.config, c.traffic
    data = corpus.make(traffic["corpus"], cfg["num_items"], 2**31 + 77)
    ds = batching.SessionDataset(data["train"], data["edges"], num_negatives=cfg["num_negatives"],
                                 max_session_length=cfg["max_session_length"], num_items=cfg["num_items"])
    sessions = rb.Sessions.from_columns(*data["train"], cfg["max_session_length"])
    graph = rb.csr(*data["edges"], cfg["num_items"])
    sched = rb.schedule(sessions, 16, epoch_seed, shuffle)
    program = list(batching.iterate_batches(ds, 16, shuffle=shuffle, seed=epoch_seed, workers=2))
    assert len(program) == len(sched)
    for i in (0, 1, len(sched) // 2, len(sched) - 1):
        chunk, n, bi = sched[i]
        ref = rb.assemble(sessions, graph, chunk, 16, n, epoch_seed, bi, cfg["num_items"], cfg["num_negatives"])
        for k, v in ref.items():
            np.testing.assert_array_equal(getattr(program[i], k).numpy(), v, err_msg=f"batch {i} {k}")


@pytest.mark.parametrize("name", ["gt_ffn.train_lazy_b512", "gt_opt.eval_b512", "gt_opt.train_eager_b128"])
def test_a_run_is_correct_against_the_reference(name):
    result = tiny.run(tiny.cell(name))
    assert result["correct"], result["checked"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name", ["gt_ffn.train_lazy_b512", "gt_opt.eval_b512"])
def test_the_control_fails_the_limits(name):
    c = tiny.cell(name)
    entry = harness.load_module(c.entry)
    numbers, _ = entry.stand_in(c.config, c.traffic, tiny.TINY_SEED, "cpu", "tf32")
    assert not harness.within(numbers, c.limits), numbers


def _keep_state(monkeypatch):
    """A step that returns its state unchanged: the optimizer's updates do nothing but count."""
    from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW

    def counted(self, *args, **kwargs):
        state = next(a for a in args if isinstance(a, dict) and "count" in a)
        state["count"] += 1
        return state

    monkeypatch.setattr(FusedEmbeddingAdamW, "update_sparse", counted)
    monkeypatch.setattr(FusedEmbeddingAdamW, "update_sparse_lazy", counted)


def _half_batch(monkeypatch):
    """Half of the batch left out of the loss, the mean taken over the rest."""
    from gat_recommendation_torch.train import losses

    dual = losses.dual_loss_emb

    def halved(s, te, ne, m=None, alpha=0.7, temperature=1.0):
        m = m.clone()
        valid = torch.nonzero(m).flatten()
        m[valid[len(valid) // 2:]] = False
        return dual(s, te, ne, m, alpha, temperature)

    monkeypatch.setattr(losses, "dual_loss_emb", halved)


def _altered_target(monkeypatch):
    """A target altered where the batch is made."""
    from gat_recommendation_torch.data import native

    assemble = native.assemble_batch

    def altered(*args, **kwargs):
        batch = assemble(*args, **kwargs)
        batch.targets[0] = 1 + batch.targets[0] % 2000
        return batch

    monkeypatch.setattr(native, "assemble_batch", altered)


def _eval_half(monkeypatch):
    """Half of each batch's answers left out."""
    from gat_recommendation_torch.train import trainer

    topk = trainer.full_catalog_topk

    def halved(sess, table, k, num_items, **kwargs):
        s, i = topk(sess, table, k, num_items, **kwargs)
        i = i.clone()
        i[sess.shape[0] // 2:] = 0
        return s, i

    monkeypatch.setattr(trainer, "full_catalog_topk", halved)


def _eval_altered(monkeypatch):
    """One answer altered where it is produced."""
    from gat_recommendation_torch.train import trainer

    topk = trainer.full_catalog_topk

    def altered(sess, table, k, num_items, **kwargs):
        s, i = topk(sess, table, k, num_items, **kwargs)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % num_items
        return s, i

    monkeypatch.setattr(trainer, "full_catalog_topk", altered)


@pytest.mark.parametrize("name,fault", [
    ("gt_ffn.train_lazy_b512", _keep_state), ("gt_ffn.train_lazy_b512", _half_batch),
    ("gt_ffn.train_lazy_b512", _altered_target), ("gt_opt.train_eager_b128", _keep_state),
    ("gt_opt.eval_b512", _eval_half), ("gt_opt.eval_b512", _eval_altered),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = tiny.run(tiny.cell(name))
    assert not result["correct"], result["checked"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cells' own size runs on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gt_ffn.train_lazy_b512", "gt_opt.eval_b512", "gt_opt.train_eager_b128"])
def test_the_control_fails_at_the_cells_own_size(card, name):
    c = harness.Cell(harness.read_json(harness.ROOT / "BENCHMARK.json"), name)
    entry = harness.load_module(c.entry)
    for seed in (2**31 + 901, 2**31 + 902, 2**31 + 903):
        numbers, _ = entry.stand_in(c.config, c.traffic, seed, card, "tf32")
        assert not harness.within(numbers, c.limits), (seed, numbers)
