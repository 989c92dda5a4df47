"""% of the lazy row kernels' roofline: the least time for the gather with
its catch-up and the touched update of the traced window's steps over the
time those kernels took (``csrc/lazy_adamw.cu``, by name).

Counted from the rows each step touches (the program's ``bench.touched_rows``
arithmetic, kept here in ``observe.py``): the gather reads a row of the
table, its two float32 moments and its last step, and the row's id, and
writes the caught-up row and moments; each element of a row touched before
catches up its missed steps (at most 64) with one reciprocal a term, at the
multi-function unit's rate. The touched update reads the caught-up row and
moments and the summed gradient, writes the row, the moments and the last
step, 16 operations an element."""

import re

from benchmark.yardstick import counts

KERNELS = re.compile(r"(?:gather_catch_up|touched_update)_kernel\b")


def step_bound(D, b):
    n = b["rows"]
    gather = counts.bound_s(n * (3 * 4 * D + 4) + 4 * n + 3 * 4 * n * D, n_mufu=D * b["row_terms"])
    update = counts.bound_s(n * (4 * 4 * D + 3 * 4 * D + 4) + 4 * n, 16.0 * D * n)
    return gather + update


def read(obs):
    trace = obs["trace"]
    if trace is None or not obs["traffic"]["lazy"]:
        return None
    spent = trace.kernels(KERNELS)
    if not spent or not obs["batches"]:
        return None
    D = obs["config"]["embedding_dim"]
    return 100.0 * sum(step_bound(D, b) for b in obs["batches"]) / sum(spent)
