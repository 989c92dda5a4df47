#!/usr/bin/env python3
"""The lazy catch-up series kernels on one NVIDIA GPU: SASS counts and times at fixed series lengths.

    python3 scripts/gpu/lazy_series.py [OTHER_lazy_adamw.cu ...]

For the shipped gat_recommendation_torch/csrc/lazy_adamw.cu and each other
version of that source given (an earlier commit's, say), all built with the
port's nvcc flags into build/kernel_variants/:

1. the series loop of the compiled gather and materialize kernels (float32
   moments), from cuobjdump -sass: its instructions, its reciprocals
   (MUFU.RCP, one an element and term), instructions an element and term,
   and the IEEE division's checks (FCHK) and branches in it;
2. device times of the gather (U = 16,384 slots, 12,000 real rows, a CUDA
   graph of 10 calls as chip_smoke.py times it) and of materialize (the full
   467,456 x 256 table, single calls on a restored state) with every row
   1,000 steps behind and the series cut at T terms, T in {1, 16, 64}; and
   T = 0: every mu zero, so every lane skips its series and what is left is
   the kernel's fixed cost (the "no series" time). Each version in turns
   (first, second, ..., second, first). Beside them the bound: bytes at
   3.35 TB/s, and for the series the larger of the loop's instructions at
   one a lane and clock and the reciprocals at 16 lanes an SM and clock;
3. each version's result at T = 64 against the plain version: weights
   within chip_smoke.py's TABLE_TOL, moments bit-equal.

The port's wrappers drive every version, so a given source must take the
shipped C interface: sources of commit 59bf4b8 and earlier lack the
``row_offset`` argument of the three entry points and cannot be compared.

chip_smoke.py's phase 7 inputs otherwise (table 0.05 N(0,1), mu 1e-3 N(0,1),
nu 1e-6 U(0,1), one row in 16 never touched). Nothing here is used by the port.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts" / "gpu"))

from chip_smoke import (  # noqa: E402
    ADAMW, DIM, LAZY_COUNT, ROWS, TABLE_TOL, _lazy_inputs, _same_bits, bound_ms, device_ms, lazy_series_sass,
    nvidia_smi, reset_ms, step_row,
)
from kernel_variants import OUT, build_variants  # noqa: E402

from gat_recommendation_torch.ops import _build, lazy_adamw  # noqa: E402

TERMS = (0, 1, 16, 64)


def state_at(gen: torch.Generator, terms: int):
    """Phase 7's state with every row 1,000 steps behind; T = 0 zeroes mu."""
    state, uid, _, n_unique = _lazy_inputs(gen, torch.float32)
    state[3].zero_()
    if terms == 0:
        state[1].zero_()
    return state, uid, n_unique


def main() -> int:
    if not torch.cuda.is_available():
        print("lazy_series: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    print(nvidia_smi(), flush=True)
    variants = {"shipped": []}
    for i, path in enumerate(sys.argv[1:]):
        variants[f"given{i}_{Path(path).parent.name}"] = [["FILE", str(Path(path).resolve())]]
    libs = build_variants("lazy_adamw", "materialize_kernelIffE", variants)
    names = list(libs)
    for name in names:
        print(json.dumps({"variant": name, "sass": lazy_series_sass(OUT / f"lazy_adamw_{name}.so")}), flush=True)
    order = names + names[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    count_row = step_row(LAZY_COUNT)
    for terms in TERMS:
        state, uid, n_unique = state_at(gen, terms)
        hp = dict(ADAMW, tail_terms=max(terms, 1))
        work = [t.clone() for t in state]

        def restore():
            for dst, src in zip(work, state):
                dst.copy_(src)

        live = (state[1] != 0).sum(1)
        real = uid[:n_unique].long()
        row_bytes = DIM * 12
        gather_et = terms * int(live[real].sum())
        mat_et = terms * int(live.sum())
        gather_bytes = n_unique * (row_bytes + 4) + 4 * uid.numel() + 3 * 4 * uid.numel() * DIM
        mat_bytes = 2 * ROWS * row_bytes + 2 * 4 * ROWS
        times: dict[str, dict[str, list]] = {n: {"gather_ms": [], "materialize_ms": []} for n in names}
        for name in order:
            _build._libs["lazy_adamw"] = libs[name]
            times[name]["gather_ms"].append(
                device_ms(lambda: lazy_adamw.gather_catch_up(*state, uid, count_row, **hp), 10, 5))
            times[name]["materialize_ms"].append(
                reset_ms(lambda: lazy_adamw.materialize(*work, LAZY_COUNT, **hp), restore, 10))
        for name in names:
            sass = lazy_series_sass(OUT / f"lazy_adamw_{name}.so")
            ipt = sass["lazy_gather_catch_up"]["instructions_per_term"]
            ipm = sass["lazy_materialize"]["instructions_per_term"]
            row = {"variant": name, "terms": terms, **times[name],
                   "gather_bound_ms": bound_ms(gather_bytes, 0, ipt * gather_et, n_mufu=gather_et),
                   "materialize_bound_ms": bound_ms(mat_bytes, 0, ipm * mat_et, n_mufu=mat_et),
                   "gather_element_terms": gather_et, "materialize_element_terms": mat_et}
            if terms == 64:
                _build._libs["lazy_adamw"] = libs[name]
                got = lazy_adamw.gather_catch_up(*state, uid, LAZY_COUNT, **hp)
                want = lazy_adamw.gather_catch_up_reference(*state, uid, LAZY_COUNT, **hp)
                restore()
                lazy_adamw.materialize(*work, LAZY_COUNT, **hp)
                plain = [t.clone() for t in state]
                lazy_adamw.materialize_reference(*plain, LAZY_COUNT, **hp)
                torch.cuda.synchronize()
                row["gather_max_abs_err"] = (got[0] - want[0]).abs().max().item()
                row["gather_within_tolerance"] = bool(torch.allclose(got[0], want[0], **TABLE_TOL))
                row["gather_moments_equal"] = _same_bits(got[1], want[1]) and _same_bits(got[2], want[2])
                row["materialize_max_abs_err"] = (work[0] - plain[0]).abs().max().item()
                row["materialize_within_tolerance"] = bool(torch.allclose(work[0], plain[0], **TABLE_TOL))
                row["materialize_moments_equal"] = all(_same_bits(a, b) for a, b in zip(work[1:], plain[1:]))
                del got, want, plain
            row["gather_ms_median"] = statistics.median(row["gather_ms"])
            row["materialize_ms_median"] = statistics.median(row["materialize_ms"])
            print(json.dumps(row), flush=True)
        del state, work
        torch.cuda.empty_cache()
    _build._libs.pop("lazy_adamw", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
