"""% of kernel 3's roofline in the eager cell: the least time for the
table's AdamW sweep of the traced window's steps over the time the sweeps
took (``csrc/embedding_adamw.cu``'s ``adamw_kernel``, by name).

A sweep reads and writes every row of the table and its two float32 moments
(6 x 4 bytes an element of the catalog's V x D), reads the touched rows'
summed gradients and their ids, 14 operations an element: the program's
frozen count of ``chip_smoke``'s kernel 3 bound. (The count of
``utils/roofline.embedding_adamw_roofline``, 7 x 4 bytes an element, is the
dense kernel 4's, which reads a dense gradient.)"""

import re

from benchmark.yardstick import counts

KERNELS = re.compile(r"(?<![A-Za-z_])adamw_kernel\b")


def read(obs):
    trace = obs["trace"]
    if trace is None or obs["traffic"]["lazy"]:
        return None
    spent = trace.kernels(KERNELS)
    if not spent or not obs["batches"]:
        return None
    cfg = obs["config"]
    V, D = cfg["num_items"], cfg["embedding_dim"]
    bound = sum(counts.bound_s(6 * 4 * V * D + 4 * b["rows"] * D + 4 * b["rows"], 14.0 * V * D)
                for b in obs["batches"])
    return 100.0 * bound / sum(spent)
