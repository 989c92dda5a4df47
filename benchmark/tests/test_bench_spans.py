"""The program's spans against the device trace (``yardstick/spans.py``) and
the ten readers of them, on made-up spans and a made-up trace checked by
hand; on the card, the replay spans of a chained Trainer align with the
trace's ``cudaGraphLaunch`` calls within 50 us."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.yardstick import spans
from benchmark.yardstick.trace import TraceData

METRICS = harness.HERE / "metrics"
US = 1000  # ns


def metric(name):
    return harness.load_module(METRICS / f"{name}.py")


def recording(rows):
    """Spans from (name, tid, start us, end us, parent index or None[, ids])."""
    out = []
    for name, tid, a, b, parent, *ids in rows:
        out.append(SimpleNamespace(name=name, tid=tid, start=a * US, end=b * US, ids=ids[0] if ids else {},
                                   parent=None if parent is None else out[parent]))
    return SimpleNamespace(spans=out)


TRAIN = recording([
    ("train.epoch", 1, 0, 100, None),  # 0
    ("wait", 1, 0, 10, 0),
    ("block", 1, 10, 12, 0),
    ("chained", 1, 12, 30, 0, {"step": 0, "steps": 3}),  # 3
    ("replay", 1, 14, 16, 3),
    ("replay", 1, 20, 22, 3),
    ("wait", 1, 40, 50, 0),
    ("single", 1, 50, 60, 0, {"step": 3}),  # 7
    ("block", 1, 51, 52, 7),
    ("readback", 1, 90, 100, 0),
    ("transfer", 2, 0, 30, None),
    ("transfer", 2, 30, 70, None),
    ("assemble", 3, 0, 20, None),
    ("assemble", 3, 20, 40, None),
    ("assemble", 3, 40, 45, None),
])

EVAL = recording([
    ("eval.pass", 1, 0, 100, None),  # 0
    ("wait", 1, 0, 10, 0),
    ("copy", 1, 10, 12, 0),
    ("chained", 1, 12, 30, 0, {"batch": 0, "steps": 3}),  # 3
    ("replay", 1, 14, 16, 3),
    ("replay", 1, 20, 22, 3),
    ("wait", 1, 30, 35, 0),
    ("copy", 1, 35, 40, 0),
    ("single", 1, 40, 45, 0, {"batch": 3}),
    ("wait", 1, 45, 50, 0),
    ("readback", 1, 80, 90, 0),
    ("metrics", 1, 90, 95, 0),
    ("assemble", 3, 0, 20, None),
    ("assemble", 3, 20, 30, None),
])


def make_trace(launches=((1014.5, 1015.5), (1020.5, 1021.5)), calls=()):
    """The card busy 1016.5-1019, 1022.5-1028, 1055-1070 and 1075-1085 us; the
    stepping thread (7) launches the two graphs and one kernel, and makes
    `calls` besides; a window of 100 us."""
    kernels = [(1016.5, 2.5), (1022.5, 5.5), (1055, 15), (1075, 10)]
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": d} for a, d in kernels]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": a, "dur": b - a, "tid": 7}
               for a, b in launches]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1055, "dur": 1, "tid": 7})
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": a, "dur": b - a, "tid": 7}
               for a, b in calls]
    return TraceData(events, window_s=100e-6)


def observation(trace):
    # busy 33 us in the traced window's 10 sessions; untraced 100,000 sessions a second: idle 67 %
    return {"trace": trace, "window": {"sessions": 10}, "untraced": {"sessions": 100_000, "seconds": 1.0}}


@pytest.fixture
def recorded(monkeypatch):
    def use(rec):
        monkeypatch.setattr(spans, "recorded", lambda: rec)
    return use


def test_the_offset_lies_between_every_replay_and_its_launch():
    trace = make_trace()
    # lo = max(1015.5 - 16, 1021.5 - 22) = 999.5, hi = min(1014.5 - 14, 1020.5 - 20) = 1000.5
    assert spans.align(TRAIN, trace) == (pytest.approx(1000.0), pytest.approx(1.0))
    assert spans.align(TRAIN, make_trace(launches=((1014.5, 1015.5),))) is None  # a launch missing
    assert spans.align(TRAIN, make_trace(launches=((1014.5, 1017.5), (1020.5, 1021.5)))) is None  # no interval


def test_span_edges_narrow_the_offset_and_a_wide_one_is_none():
    # A call at 1029.8-1030.8 us: the chained span's end (30 us) may not fall inside it, so the offset is
    # not in (999.8, 1000.8): [999.5, 999.8] is left of the replays' [999.5, 1000.5].
    assert spans.align(TRAIN, make_trace(calls=((1029.8, 1030.8),))) == (pytest.approx(999.65), pytest.approx(0.3))
    assert spans.align(TRAIN, make_trace(calls=((1029, 1031),))) is None  # every offset cut
    wide = recording([("train.epoch", 1, 0, 1000, None), ("replay", 1, 100, 200, 0), ("wait", 1, 300, 400, 0)])
    # The replay alone: [1141 - 200, 1140 - 100] = [941, 1040], 99 us, over 50.
    assert spans.align(wide, make_trace(launches=((1140, 1141),))) is None
    # The wait's end (400 us) outside the call 1341-1400 cuts (941, 1000): 40 us are left.
    assert spans.align(wide, make_trace(launches=((1140, 1141),), calls=((1341, 1400),))) == (
        pytest.approx(1020.0), pytest.approx(40.0))


def test_the_dispatches_carry_the_steps_and_batches():
    assert spans.dispatched(TRAIN, "step") == 4 and spans.dispatched(TRAIN, "batch") == 0
    assert spans.dispatched(EVAL, "batch") == 4 and spans.dispatched(EVAL, "step") == 0
    assert spans.dispatched(None, "step") == 0


def test_the_stepping_thread_and_the_outermost_spans():
    assert spans.stepping(TRAIN) == 1
    names = ("block", "chained", "single")
    assert [(s.start // US, s.end // US) for s in spans.outermost(TRAIN, names, 1)] == [(10, 12), (12, 30), (50, 60)]
    # (5, 25) and (24, 26) merge to (5, 26): 5 us of the first gap and 6 of the second
    assert spans.covered_s([(0, 10), (20, 30)], [(5, 25), (24, 26), (40, 50)]) == pytest.approx(11e-6)


def test_the_training_readers_by_hand(recorded):
    recorded(TRAIN)
    obs = observation(make_trace())
    assert metric("idle_share.train").read(obs) == pytest.approx(67.0)
    assert metric("wait_ms.train").read(obs) == pytest.approx(20e-3 / 4)
    assert metric("dispatch_ms.train").read(obs) == pytest.approx(30e-3 / 4)  # the block inside single once
    assert metric("transfer_ms.train").read(obs) == pytest.approx(70e-3 / 4)
    assert metric("assembly_busy_ms.train").read(obs) == pytest.approx(45e-3 / 3)
    # Idle gaps 1014.5-1016.5, 1019-1022.5, 1028-1055, 1070-1075 (67 us with the edges). Waits cover
    # 1040-1050; dispatches 2 + 3.5 + 2 (chained) + 5 (single) = 12.5 us.
    wait = metric("idle_wait_share.train").read(obs)
    dispatch = metric("idle_dispatch_share.train").read(obs)
    assert wait == pytest.approx(67.0 * 10 / 67) and dispatch == pytest.approx(67.0 * 12.5 / 67)
    assert wait + dispatch <= metric("idle_share.train").read(obs)


def test_the_evaluation_readers_by_hand(recorded):
    recorded(EVAL)
    obs = observation(make_trace())
    assert metric("dispatch_ms.eval").read(obs) == pytest.approx(30e-3 / 4)
    assert metric("readback_ms.eval").read(obs) == pytest.approx(15e-3)
    assert metric("assembly_busy_ms.eval").read(obs) == pytest.approx(15e-3)
    # Waits 1000-1010, 1030-1035, 1045-1050 cover 1030-1035 and 1045-1050 of the gap 1028-1055.
    assert metric("idle_wait_share.eval").read(obs) == pytest.approx(67.0 * 10 / 67)


READERS = ("wait_ms.train", "dispatch_ms.train", "transfer_ms.train", "assembly_busy_ms.train",
           "idle_wait_share.train", "idle_dispatch_share.train", "assembly_busy_ms.eval", "dispatch_ms.eval",
           "readback_ms.eval", "idle_wait_share.eval")


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_spans_or_alignment(name, recorded, monkeypatch):
    obs = observation(make_trace(launches=((1014.5, 1015.5),)))
    recorded(None)
    assert metric(name).read(obs) is None
    recorded(recording([]))
    assert metric(name).read(obs) is None
    if name.startswith("idle_"):  # spans, but no alignment
        recorded(TRAIN if name.endswith("train") else EVAL)
        assert metric(name).read(obs) is None
        assert metric(name).read(dict(obs, trace=None)) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    import gat_recommendation_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "gat_recommendation_torch.utils.tracing", None)
    assert spans.recorded() is None
    assert metric("wait_ms.train").read(observation(make_trace())) is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the replay spans are aligned with the card's trace")
    return "cuda"


@pytest.mark.cuda
def test_replay_spans_align_with_the_card_trace(card, tmp_path):
    from gat_recommendation_torch import bench
    from gat_recommendation_torch.data.batching import iterate_batches
    from gat_recommendation_torch.models.registry import create_model
    from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
    from gat_recommendation_torch.train.trainer import Trainer
    from gat_recommendation_torch.utils import tracing
    from benchmark.yardstick.trace import Tracer

    ds, _ = bench.make_corpus(3000, num_items=2000)
    model = create_model("graph_transformer_optimized", 2000, device=card, embedding_dim=32, hidden_dim=32,
                         laplacian_k=4)
    trainer = Trainer(model, lambda epoch: iterate_batches(ds, 64, shuffle=True, seed=epoch % 2, workers=2),
                      lambda: iterate_batches(ds, 64, workers=2),
                      optimizer=FusedEmbeddingAdamW(1e-3, lazy=True), output_dir=tmp_path, k_values=[10],
                      sparse_embedding_grads=True, chain=8, transfer_workers=2, device=card)
    trainer.init_state(reset_parameters=False)
    for epoch in range(2):  # every graph captured
        trainer.current_epoch = epoch
        trainer.train_epoch()
    trainer.evaluate()
    tracing.take()
    tracer = Tracer()
    tracer.arm()
    tracer.begin()
    for epoch in range(2):
        trainer.current_epoch = epoch
        trainer.train_epoch()
    trainer.evaluate()
    tracer.end()
    data = tracer.read()
    rec = tracing.take()
    replays = [s for s in rec.spans if s.name == "replay"]
    assert replays and not [s for s in rec.spans if s.name == "capture"]
    found = spans.align(rec, data)
    assert found is not None and found[1] < 50.0, found
