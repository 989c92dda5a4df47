"""% of full-catalog scoring's roofline: the least time to score the traced
window's valid sessions against every item over the time kernel 2
(``csrc/score_chunkmax.cu``) and the selection after it (the stable sorts
and gathers of ``ops/scoring.py``, by name) took.

A batch's bound is the larger of 2 B V D products over 67 TFLOP/s and its
bytes over 3.35 TB/s: the table read once, the session rows read and the
top-k ids written. The [B, V] scores are not counted as traffic: a fused
implementation that never writes them is measured against the same work."""

import re

from benchmark.yardstick import counts

KERNELS = re.compile(r"score_chunkmax(?:_tile)?_kernel\b|[Ss]ort|fill_index_and_segment|scatter_gather")


def read(obs):
    trace = obs["trace"]
    if trace is None:
        return None
    spent = trace.kernels(KERNELS)
    if not spent or not obs["batches"]:
        return None
    cfg, k = obs["config"], max(obs["traffic"]["k_values"])
    V, D = cfg["num_items"], cfg["embedding_dim"]
    bound = sum(counts.bound_s(4 * V * D + 4 * b["valid"] * D + 8 * b["valid"] * k, 2.0 * b["valid"] * V * D)
                for b in obs["batches"])
    return 100.0 * bound / sum(spent)
