"""The readings the check's limits are set from, for one cell on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --variants program,tf32,half_batch

``program``: the program's check as a run makes it (set-up and, for the
evaluation, one pass), judged by the reference, without the measured window:
the lower reading is the largest over a dozen seeds or more. ``tf32``: the
control, the reference computed on TF32 operands put in the program's place;
its smallest reading over three seeds or more is the upper reading. The
entry's faults (training: ``half_batch``, ``altered_target``; evaluation:
``half_batch``, ``altered_answer``) are the reference with the fault planted,
in the program's place. A state left unchanged reads ``change_gap`` 1 and
needs no run. Training's ``float64`` is a witness, not a control: the same
reference in float64 in the program's place, a second sound computation,
which shows how far two sound computations part on a seed. Every seed's numbers print as one JSON line; the last line
holds each variant's least and largest reading of each number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[:1] = [str(Path(__file__).resolve().parent.parent)]

from benchmark import harness  # noqa: E402


def program_numbers(cell, seed: int, device) -> tuple[dict, dict]:
    import torch

    entry = harness.load_module(cell.entry)
    session = entry.Session(cell.config, cell.traffic, seed, device, harness.SetupClock(time.perf_counter()),
                            warm_up=False)
    session.window(0.0)
    outputs = session.close()
    del session
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return entry.check(cell.config, cell.traffic, seed, device, outputs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variants", default="program,tf32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.Cell(harness.read_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    entry = harness.load_module(cell.entry)
    summary: dict = {}
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            if variant == "program":
                numbers, details = program_numbers(cell, seed, args.device)
            elif variant in entry.VARIANTS:
                numbers, details = entry.stand_in(cell.config, cell.traffic, seed, args.device, variant)
            else:
                raise SystemExit(f"unknown variant {variant!r}: program or one of {entry.VARIANTS}")
            print(json.dumps({"workload": cell.name, "variant": variant, "seed": seed, "numbers": numbers,
                              "details": details, "seconds": time.perf_counter() - t}), flush=True)
            for k, v in numbers.items():
                lo, hi = summary.setdefault(variant, {}).get(k, (v, v))
                summary[variant][k] = (min(lo, v), max(hi, v))
    print(json.dumps({"workload": cell.name, "least_and_largest": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
