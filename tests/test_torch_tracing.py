"""The port's spans (``gat_recommendation_torch/utils/tracing.py``) on the CPU.

Off, every site returns the one shared ``OFF`` object and nothing is kept,
not even a collector callback. On, under a ``torch.profiler`` active cycle
with the benchmark's schedule (off while armed, on while active, off after
stop) or inside ``recording()``, spans carry their thread, their parent on
that thread and their ids. A CPU Trainer with ``chain=3`` gives one span of
each name for each dispatch, item, batch and graph-free step, the
dispatches carrying the steps and batches run.
"""

import gc
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from gat_recommendation_torch import bench
from gat_recommendation_torch.data.batching import chain_iterator, iterate_batches
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import Trainer
from gat_recommendation_torch.utils import tracing

ITEMS, BATCH, CHAIN = 400, 16, 3


@pytest.fixture(scope="module")
def dataset():
    ds, _ = bench.make_corpus(420, num_items=ITEMS)
    return ds


def make_trainer(ds, tmp_path, workers=2, transfer_workers=2):
    model = create_model("graph_transformer_optimized", ITEMS, device="cpu", embedding_dim=16, hidden_dim=16,
                         laplacian_k=4, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, lambda epoch: iterate_batches(ds, BATCH, shuffle=True, seed=epoch, workers=workers),
                      lambda: iterate_batches(ds, BATCH, workers=workers),
                      optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True), output_dir=tmp_path,
                      k_values=[5, 10], sparse_embedding_grads=True, chain=CHAIN, transfer_workers=transfer_workers,
                      device="cpu")
    trainer.init_state(reset_parameters=False)
    return trainer


def named(rec, name, tid=None):
    return [s for s in rec.spans if s.name == name and (tid is None or s.tid == tid)]


def test_off_every_site_returns_the_shared_no_op_and_keeps_nothing(dataset, tmp_path, monkeypatch):
    tracing.take()
    returned = []
    span = tracing.span

    def watched(*args, **kwargs):
        returned.append(span(*args, **kwargs))
        return returned[-1]

    monkeypatch.setattr(tracing, "span", watched)
    trainer = make_trainer(dataset, tmp_path)
    trainer.train_epoch()
    trainer.evaluate()
    assert len(returned) > 50 and all(r is tracing.OFF for r in returned)
    assert not tracing.OFF and tracing.span(tracing.WAIT, batch=1) is tracing.span(tracing.REPLAY) is tracing.OFF
    rec = tracing.recorded()
    assert rec.spans == []
    assert tracing._on_gc not in gc.callbacks


def test_the_profilers_active_cycle_records_and_take_starts_afresh():
    tracing.take()
    prof = profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()  # armed: the warm-up cycle records nothing
    with tracing.span(tracing.WAIT, batch=0) as armed:
        pass
    prof.step()  # the active cycle
    with tracing.span(tracing.EPOCH, epoch=3) as root:
        with tracing.span(tracing.SINGLE, step=7) as child:
            pass
        gc.collect()
    assert tracing._on_gc in gc.callbacks  # collections are spans while recording
    prof.stop()
    with tracing.span(tracing.WAIT) as after:
        pass
    assert armed is tracing.OFF and after is tracing.OFF
    assert tracing._on_gc not in gc.callbacks  # the first site after the stop removes the callback
    first = tracing.recorded()
    assert tracing.recorded() is first  # not cleared by reading
    assert [s.name for s in first.spans if s.name != tracing.GC] == [tracing.SINGLE, tracing.EPOCH]
    assert child.parent is root and root.parent is None
    assert tracing.ids(child) == {"epoch": 3, "step": 7} and child.ids == {"step": 7}
    assert root.start <= child.start <= child.end <= root.end
    collections = named(first, tracing.GC)
    assert collections and all(s.tid == root.tid and s.parent is root for s in collections)
    assert tracing.take() is first and tracing.recorded() is not first

    prof = profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    prof.step()
    with tracing.span(tracing.PASS, pass_=1):
        pass
    prof.stop()
    second = tracing.take()
    assert [s.name for s in second.spans if s.name != tracing.GC] == [tracing.PASS]
    assert [s.name for s in first.spans if s.name != tracing.GC] == [tracing.SINGLE, tracing.EPOCH]
    assert tracing.PASS not in {s.name for s in first.spans}


def test_recordings_nest_and_keep_each_threads_parents():
    with tracing.recording() as outer:
        with tracing.recording() as inner:
            barrier = threading.Barrier(4)

            def work(i):
                with tracing.span(tracing.TRANSFER, batch=i):
                    barrier.wait(timeout=10)
                    with tracing.span(tracing.ASSEMBLE):
                        pass

            threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
        with tracing.span(tracing.READBACK):
            pass
    assert tracing._on_gc not in gc.callbacks
    assert len(inner.spans) == 8 and len(outer.spans) == 9 and inner.spans == outer.spans[:8]
    transfers = named(inner, tracing.TRANSFER)
    assert sorted(s.ids["batch"] for s in transfers) == [0, 1, 2, 3] and len({s.tid for s in transfers}) == 4
    for s in named(inner, tracing.ASSEMBLE):
        assert s.parent.name == tracing.TRANSFER and s.parent.tid == s.tid
        assert tracing.ids(s) == s.parent.ids
    assert tracing.recorded().spans == []  # no profiler: the profiler-keyed recording holds nothing


def test_a_chained_cpu_trainer_gives_every_span_and_counter(dataset, tmp_path):
    trainer = make_trainer(dataset, tmp_path)
    batches = len(list(iterate_batches(dataset, BATCH)))
    with tracing.recording() as rec:
        trainer.train_epoch()
    tid = threading.get_native_id()
    (epoch,) = named(rec, tracing.EPOCH)
    chained, single = named(rec, tracing.CHAINED), named(rec, tracing.SINGLE)
    assert len(chained) == trainer.chained_dispatches
    assert sum(s.ids["steps"] for s in chained) + len(single) == batches
    assert len(named(rec, tracing.ASSEMBLE)) == batches
    transfers, waits = named(rec, tracing.TRANSFER), named(rec, tracing.WAIT)
    # One wait a prefetched item (a chain group) and one for the end of the feed.
    assert len(waits) == len(transfers) + 1 and [s.ids["batch"] for s in waits] == list(range(len(waits)))
    assert sorted(s.ids["batch"] for s in transfers) == list(range(len(transfers)))
    assert all(s.tid != tid for s in transfers + named(rec, tracing.ASSEMBLE))
    blocks = named(rec, tracing.BLOCK)
    assert len(blocks) == len(chained) + len(single) and named(rec, tracing.REPLAY) == []  # no graphs on the CPU
    for s in chained + single + waits + [b for b in blocks if b.parent.name != tracing.SINGLE]:
        assert s.tid == tid and s.parent is epoch and tracing.ids(s)["epoch"] == trainer.current_epoch
    # A step's spans share its step: the optimizer's count before it.
    steps = sorted([s.ids["step"] for s in chained] + [s.ids["step"] for s in single])
    assert steps[0] == 0 and steps[-1] == batches - 1
    for s in single:
        (b,) = [b for b in blocks if b.parent is s]
        assert b.ids["step"] == s.ids["step"] and b.ids["steps"] == 1
    (readback,) = named(rec, tracing.READBACK)
    assert readback.parent is epoch and readback.start >= max(s.end for s in chained + single)

    passes_before = trainer.chained_eval_dispatches
    with tracing.recording() as rec:
        trainer.evaluate()
    (root,) = named(rec, tracing.PASS)
    chained, single = named(rec, tracing.CHAINED), named(rec, tracing.SINGLE)
    assert len(chained) == trainer.chained_eval_dispatches - passes_before
    assert CHAIN * len(chained) + len(single) == batches == sum(s.ids.get("steps", 1) for s in chained + single)
    assert not [s for s in chained + single if "step" in s.ids]  # a batch, not a training step
    assert len(named(rec, tracing.COPY)) == len(chained) + len(single)
    assert len(named(rec, tracing.ASSEMBLE)) == batches
    waits = named(rec, tracing.WAIT)  # one a group, one for the end
    groups = [len(g) for g in chain_iterator(iterate_batches(dataset, BATCH), CHAIN)]
    assert [s.ids["batch"] for s in waits] == [sum(groups[:i]) for i in range(len(groups) + 1)]
    for name in (tracing.READBACK, tracing.METRICS):
        (s,) = named(rec, name)
        assert s.parent is root and tracing.ids(s) == {"pass_": 0}
    firsts = sorted(s.ids["batch"] for s in chained + single)
    assert firsts == sorted(set(firsts)) and all(s.parent is root for s in chained + single + waits)


def test_inline_assembly_nests_under_the_evaluations_wait(dataset, tmp_path):
    trainer = make_trainer(dataset, tmp_path, workers=0, transfer_workers=1)
    with tracing.recording() as rec:
        trainer.evaluate()
    assembled = named(rec, tracing.ASSEMBLE)
    assert assembled and all(s.parent.name == tracing.WAIT for s in assembled)
    assert np.all(np.diff([s.ids["batch"] for s in assembled]) == 1)
