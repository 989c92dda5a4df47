"""The operation and byte counts of the per-layer metrics against hand
counts at small shapes, and the trace's reduction on a made-up trace."""

from __future__ import annotations

import math
import re

import pytest

from benchmark import harness
from benchmark.yardstick import counts
from benchmark.yardstick.trace import EDGES, NO_OP, TraceData

METRICS = harness.HERE / "metrics"
CFG = {"embedding_dim": 4, "hidden_dim": 4, "num_heads": 2, "num_layers": 1, "laplacian_k": 2,
       "use_laplacian_pe": True, "use_ffn": False, "ffn_expansion": 2, "num_negatives": 1, "num_items": 10}
PEAK, BW = counts.PEAKS["fp32_flop_per_s"], counts.PEAKS["hbm_bytes_per_s"]


def metric(name):
    return harness.load_module(METRICS / f"{name}.py")


def test_forward_flops_by_hand():
    # 3 nodes, 2 edges, D = HD = 4, k = 2, one layer:
    # PE 2*3*2*4 = 48; q,k,v,skip 4*2*3*4*4 = 384; gate 2*3*12 = 72; attention 4*2*4 = 32.
    assert counts.forward_flops(CFG, nodes=3, edges=2) == 48 + 384 + 72 + 32
    ffn = dict(CFG, use_ffn=True)  # up and down: 2 * 2*3*4*8 = 384
    assert counts.forward_flops(ffn, nodes=3, edges=2) == 536 + 384
    # training: 3 x (forward + loss 2*1*(1+1)*4 = 16)
    assert counts.train_flops(CFG, sessions=1, nodes=3, edges=2) == 3 * (536 + 16)
    # evaluation: forward + 2*D*V = 2*4*10 a session
    assert counts.eval_flops(CFG, sessions=2, nodes=3, edges=2) == 536 + 160


def test_bound_takes_the_larger_side():
    assert counts.bound_s(n_bytes=BW, n_flops=0) == pytest.approx(1.0)
    assert counts.bound_s(n_bytes=BW, n_flops=2 * PEAK) == pytest.approx(2.0)
    assert counts.bound_s(n_mufu=counts.PEAKS["mufu_per_s"]) == pytest.approx(1.0)


class FakeTrace:
    def __init__(self, kernels: dict, window_s=1.0, busy_s=0.25):
        self.names, self.window_s, self.busy_s = kernels, window_s, busy_s

    def kernels(self, pattern):
        return [s for name, s in self.names.items() if pattern.search(name)]


def test_attention_bound_by_hand():
    b = {"nodes": 3, "edges": 2, "adj_bytes": 3, "valid": 1}
    # forward 4*4*3*4 + 3 = 195 bytes, 4*4*2 = 32 products; backward 7*4*3*4 + 3 = 339 bytes, 80 products
    want = max(195 / BW, 32 / PEAK) + max(339 / BW, 80 / PEAK)
    m = metric("attention_roofline.train")
    assert m.launch_bounds(CFG, b) == pytest.approx(want)
    trace = FakeTrace({"void (anonymous namespace)::session_attention_staged_kernel<4>(float*)": 2 * want,
                       "void (anonymous namespace)::session_attention_backward_kernel(float*)": 2 * want,
                       "void (anonymous namespace)::empty_kernel()": 1.0})
    assert m.read({"trace": trace, "batches": [b], "config": CFG}) == pytest.approx(25.0)


def test_lazy_rows_bound_by_hand():
    b = {"rows": 2, "row_terms": 3}
    D = 4
    gather = max((2 * (3 * 4 * D + 4) + 8 + 3 * 4 * 2 * D) / BW, D * 3 / counts.PEAKS["mufu_per_s"])
    update = max((2 * (4 * 4 * D + 3 * 4 * D + 4) + 8) / BW, 16 * D * 2 / PEAK)
    m = metric("lazy_rows_roofline.train")
    assert m.step_bound(D, b) == pytest.approx(gather + update)
    trace = FakeTrace({"void gather_catch_up_kernel<float, float>()": gather + update,
                       "void touched_update_kernel<float, float>()": gather + update})
    obs = {"trace": trace, "batches": [b], "config": CFG, "traffic": {"lazy": True}}
    assert m.read(obs) == pytest.approx(50.0)
    assert m.read(dict(obs, traffic={"lazy": False})) is None


def test_sparse_adamw_bound_by_hand():
    b = {"rows": 2}
    V, D = CFG["num_items"], CFG["embedding_dim"]
    want = max((6 * 4 * V * D + 4 * 2 * D + 8) / BW, 14 * V * D / PEAK)
    trace = FakeTrace({"void (anonymous namespace)::adamw_kernel<float, float, true>()": 4 * want,
                       "void at::native::multi_tensor_apply_kernel<FusedAdamMathFunctor>()": 1.0,
                       "void fused_adamw_kernel()": 1.0})
    m = metric("sparse_adamw_roofline.train")
    assert m.read({"trace": trace, "batches": [b], "config": CFG, "traffic": {"lazy": False}}) == pytest.approx(25.0)


def test_scoring_bound_by_hand():
    b = {"valid": 2, "nodes": 3, "edges": 2}
    V, D, k = CFG["num_items"], CFG["embedding_dim"], 3
    want = max((4 * V * D + 4 * 2 * D + 8 * 2 * k) / BW, 2 * 2 * V * D / PEAK)
    trace = FakeTrace({"void (anonymous namespace)::score_chunkmax_tile_kernel()": want,
                       "void at::native::sortKeyValueInplace<float>()": want,
                       "void gemm_kernel()": 5.0})
    m = metric("scoring_roofline.eval")
    obs = {"trace": trace, "batches": [b], "config": CFG, "traffic": {"k_values": [1, k]}}
    assert m.read(obs) == pytest.approx(50.0)


def test_mfu_and_shares_by_hand():
    b = {"valid": 1, "nodes": 3, "edges": 2}
    trace = FakeTrace({}, window_s=2.0, busy_s=0.5)
    # the traced window: 4 sessions in 2 s; the untraced one: 12 sessions in 2 s, 6 a second
    obs = {"trace": trace, "batches": [b, b], "config": CFG, "traffic": {"chain": 4, "k_values": [1]},
           "steps": 8, "chained_steps": 4, "eval_batches": 8, "chained_eval_dispatches": 2,
           "waits": [0.001, 0.003], "window": {"sessions": 4, "seconds": 2.0},
           "untraced": {"sessions": 12, "seconds": 2.0}}
    assert metric("mfu.train").read(obs) == pytest.approx(100 * (2 * 3 * 552 / 4) * 6 / PEAK)
    assert metric("mfu.eval").read(obs) == pytest.approx(100 * (2 * (536 + 80) / 4) * 6 / PEAK)
    assert metric("idle_share.train").read(obs) == pytest.approx(100 * (1 - 0.5 / 4 * 6))
    assert metric("idle_share.eval").read(obs) == pytest.approx(25.0)
    assert metric("chained_share.train").read(obs) == pytest.approx(50.0)
    assert metric("chained_share.eval").read(obs) == pytest.approx(100.0)
    assert metric("assembly_ms.train").read(obs) == pytest.approx(2.0)
    assert metric("mfu.train").read(dict(obs, trace=None)) is None
    for name in ("mfu.train", "mfu.eval", "idle_share.train", "idle_share.eval"):
        assert metric(name).read(dict(obs, untraced=None)) is None


def test_kernel_names_that_no_longer_match_read_absent():
    obs = {"trace": FakeTrace({"renamed_kernel": 1.0}), "batches": [{"nodes": 1, "edges": 0, "adj_bytes": 1,
                                                                      "valid": 1, "rows": 1, "row_terms": 0}],
           "config": CFG, "traffic": {"lazy": True, "k_values": [1]}}
    for name in ("attention_roofline.train", "lazy_rows_roofline.train", "scoring_roofline.eval"):
        assert metric(name).read(obs) is None


def test_trace_reduction():
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 110, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 120, "dur": 20},   # overlaps a: union 110-140
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 160, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 190, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 100, "dur": 8, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 145, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 148, "dur": 4, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 170, "dur": 30, "tid": 2},
    ]
    t = TraceData(events, window_s=1.5e-4)
    assert (t.w0, t.w1) == (100, 200) and len(t.host) == 3  # thread 1 launched most
    assert t.busy_s == pytest.approx((30 + 10 + 10) / 1e6)
    assert t.gaps() == [(100, 110), (140, 160), (170, 190)]
    assert t.kernels(re.compile("^a$")) == [pytest.approx(20e-6), pytest.approx(10e-6)]
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["a", pytest.approx(30e-6)]
    idle = dict(bd["idle_gaps"])
    assert idle["cudaLaunchKernel"] == pytest.approx(20e-6)  # innermost at the gap's middle, 150
    assert idle["cudaStreamSynchronize"] == pytest.approx(10e-6)
    assert idle[NO_OP] == pytest.approx(20e-6)  # the other thread's copy does not count
    assert idle[EDGES] == pytest.approx(50e-6)
    assert all(math.isfinite(v) for _, v in bd["idle_gaps"])
