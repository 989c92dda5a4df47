"""% of the card's float32 peak (67 TFLOP/s, outside the tensor cores: the
port keeps TF32 off) that the model's products make of the measured
window's time: the products a session needs (forward, the loss's scores and
the backward; ``yardstick/counts.py::train_flops``: real nodes and edges of
the valid sessions only; not the optimizer, not the padding), counted over
the traced window's whole epochs, times the untraced window's sessions a
second (the tracer slows the host, so the traced window's own time would
read the tracer's cost)."""

from benchmark.yardstick import counts


def read(obs):
    plain = obs.get("untraced")
    if obs["trace"] is None or not obs["batches"] or plain is None:
        return None
    cfg = obs["config"]
    flops = sum(counts.train_flops(cfg, b["valid"], b["nodes"], b["edges"]) for b in obs["batches"])
    per_session = flops / obs["window"]["sessions"]
    return 100.0 * per_session * plain["sessions"] / (plain["seconds"] * counts.PEAKS["fp32_flop_per_s"])
