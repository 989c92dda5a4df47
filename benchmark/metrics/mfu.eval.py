"""% of the card's float32 peak that the evaluation's needed products make
of the measured window's time: the eval forward of the valid sessions and
their full-catalog scores, 2 D V a session
(``yardstick/counts.py::eval_flops``), counted over the traced window's
whole passes, times the untraced window's sessions a second."""

from benchmark.yardstick import counts


def read(obs):
    plain = obs.get("untraced")
    if obs["trace"] is None or not obs["batches"] or plain is None:
        return None
    cfg = obs["config"]
    flops = sum(counts.eval_flops(cfg, b["valid"], b["nodes"], b["edges"]) for b in obs["batches"])
    per_session = flops / obs["window"]["sessions"]
    return 100.0 * per_session * plain["sessions"] / (plain["seconds"] * counts.PEAKS["fp32_flop_per_s"])
