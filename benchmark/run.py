"""Run one cell of BENCHMARK.json once, on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (building the program's kernels on a checkout's first run, the corpus,
the model and its weights, the check steps, the warm-up), then ``--seconds``
of the cell's entry, then the check against the reference. Earlier lines and
the check's numbers go to standard error; the last line of standard output
is the result. Without enough CUDA devices it exits non-zero and prints no
result. The program's kernel caches stay inside the checkout (``build/``).
The process keeps the thread settings it is given, as a user's run of the
program has them.
"""

import os
import sys
import time
from pathlib import Path

START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:1] = [str(ROOT)]  # the checkout's root, not this directory

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(start=START))
