"""% of kernel 1's roofline in training: the least time the card needs for
the attention's forward and backward launches of the traced window's steps
(one of each a layer and step) over the time those launches took
(``csrc/session_attention.cu``: the forward kernels and the backward, by
name).

A launch's bound is the larger of its bytes over 3.35 TB/s and its
products over 67 TFLOP/s, counted from the batch's valid sessions: forward,
q, k and v read and the output written once for each real node (4 x 4 bytes
x heads x head width), the bit-packed adjacency rows of the real nodes, and
two products a head and edge (the score and the weighted value row);
backward, q, k, v and the output's gradient read and three gradients written
(7 x 4 bytes a node and width), the same rows, and five products a head and
edge (the scores again, dO.v, dV, dK, dQ). The program's frozen count of
``chip_smoke.attention_bounds``, at real nodes in place of padded slots."""

import re

from benchmark.yardstick import counts

KERNELS = re.compile(r"session_attention_(?:staged_|backward_)?kernel\b")


def launch_bounds(cfg, b):
    HD = counts.heads_width(cfg)
    fwd = counts.bound_s(4 * 4 * b["nodes"] * HD + b["adj_bytes"], 4.0 * HD * b["edges"])
    bwd = counts.bound_s(7 * 4 * b["nodes"] * HD + b["adj_bytes"], 10.0 * HD * b["edges"])
    return cfg["num_layers"] * (fwd + bwd)


def read(obs):
    trace = obs["trace"]
    if trace is None:
        return None
    spent = trace.kernels(KERNELS)
    if not spent or not obs["batches"]:
        return None
    return 100.0 * sum(launch_bounds(obs["config"], b) for b in obs["batches"]) / sum(spent)
