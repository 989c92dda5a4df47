#!/usr/bin/env python3
"""Time edited variants of a CUDA kernel source against the shipped one, on one NVIDIA GPU.

    python3 scripts/gpu/kernel_variants.py score '{"two_blocks": [["__launch_bounds__(kTileThreads, 1)", "__launch_bounds__(kTileThreads, 2)"]]}'
    python3 scripts/gpu/kernel_variants.py attn  scripts/gpu/variants/attn.json
    python3 scripts/gpu/kernel_variants.py bwd   scripts/gpu/variants/bwd.json
    python3 scripts/gpu/kernel_variants.py lazy  scripts/gpu/variants/lazy.json

The variants are one JSON object, given as text or as the path of a file
(scripts/gpu/variants/ holds the sets whose times PERF.md quotes). A variant
is a name and a list of [old, new] text substitutions applied to
gat_recommendation_torch/csrc/score_chunkmax.cu ("score"),
session_attention.cu ("attn": the forward kernels, "bwd": the backward) or
lazy_adamw.cu ("lazy": materialize and the gather); a
first pair ["FILE", path] takes a whole other source instead. The variant "shipped" (no substitution) is always
added. Every variant is compiled with the port's nvcc flags into
build/kernel_variants/ (all at once), loaded with ctypes and called through
the batch entry point (`*_forward_variant` with the batch kernel named) on
the shapes the training path uses: scoring at B = 512 (and 8, 64, 128) over
the full 467,456 x 256 table, the attention forward at B = 512, N in {56, 32,
16, 8}, 2 heads of 128, dropout 0.1 (the row kernel also at B = 1, the serving
shape), the attention backward at the same B = 512 shapes (adjacency density
0.3, and 0.0025 at N = 56), the lazy kernels over the full table with
chip_smoke.py's phase 7 inputs (float32 moments, rows 0 .. 65 and several
hundred steps behind; materialize from single calls on a restored state,
through the port's own wrapper). Printed per variant: ptxas registers and
spills of the batch kernel, whether the result is within the smoke test's
tolerance of the plain PyTorch version, its largest error, and device ms per
call (CUDA graph of calls, median of replays, as chip_smoke.py times). A
substitution that removes a phase makes the result wrong and shows what the
phase costs. The library yardsticks (torch.matmul + amax, SDPA) are timed
beside them. Nothing here is used by the port.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    ADAMW, ATTN_GRAD_TOL, ATTN_TOL, DIM, HEADS, LAZY_COUNT, NUM_ITEMS, ROWS, SCORE_TOL, TABLE_TOL, _lazy_inputs,
    device_ms, nvidia_smi, reset_ms, step_row, tol_ratio,
)
from gat_recommendation_torch.ops import _build  # noqa: E402
from gat_recommendation_torch.ops import lazy_adamw  # noqa: E402
from gat_recommendation_torch.ops.score_chunkmax import score_chunkmax_reference  # noqa: E402
from gat_recommendation_torch.ops.session_attention import (  # noqa: E402
    keep_threshold,
    session_attention_reference,
)

OUT = REPO / "build" / "kernel_variants"
SOURCES = {
    "score": ("score_chunkmax", "tile_kernel"),
    "attn": ("session_attention", "staged_kernelILb1ELi4"),
    "bwd": ("session_attention", "backward_kernelILi4"),
    "lazy": ("lazy_adamw", "materialize_kernelIffE"),
}


def build_variants(source: str, kernel_tag: str, variants: dict) -> dict:
    """Compile every variant (in parallel); returns {name: ctypes library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, subs in variants.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        if subs and subs[0][0] == "FILE":
            text, subs = Path(subs[0][1]).read_text(), subs[1:]
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        src, lib = OUT / f"{source}_{name}.cu", OUT / f"{source}_{name}.so"
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
        jobs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log[-4000:]}")
        ours = False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                ours = kernel_tag in line
            elif ours and ("registers" in line or "spill" in line):
                print(f"{name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def time_scoring(libs: dict, gen: torch.Generator) -> None:
    dev = torch.device("cuda")
    table = torch.randn(ROWS, DIM, device=dev, generator=gen)
    B = 512
    sess = torch.randn(B, DIM, device=dev, generator=gen)
    want = score_chunkmax_reference(sess, table, NUM_ITEMS, None)
    finite = torch.isfinite(want[0])
    scores = torch.empty((B, ROWS), device=dev)
    maxes = torch.empty((B, ROWS // 32), device=dev)
    for name, lib in libs.items():
        fn = lib.score_chunkmax_forward_variant
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

        def run(batch=B):
            err = fn(sess.data_ptr(), table.data_ptr(), None, scores.data_ptr(), maxes.data_ptr(),
                     batch, ROWS, DIM, NUM_ITEMS, 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        row = {
            "variant": name,
            "within_tolerance": torch.allclose(scores, want[0], **SCORE_TOL) and torch.allclose(maxes, want[1], **SCORE_TOL),
            "max_abs_err": (scores - want[0])[finite].abs().max().item(),
            "B512_ms": device_ms(run, 10, 5),
        }
        for batch in (8, 64, 128):
            row[f"B{batch}_ms"] = device_ms(lambda: run(batch), 10, 5)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "library_ms": device_ms(lambda: torch.matmul(sess, table.T).view(B, -1, 32).amax(-1), 10, 5),
        "matmul_only_ms": device_ms(lambda: torch.matmul(sess, table.T), 10, 5),
    }))


def time_attention(libs: dict, gen: torch.Generator) -> None:
    dev = torch.device("cuda")
    B, d, p_drop, seed = 512, DIM // HEADS, 0.1, 5
    for N in (56, 32, 16, 8):
        q, k, v = (torch.randn(B, N, DIM, device=dev, generator=gen) for _ in range(3))
        adj = torch.rand(B, N, N, device=dev, generator=gen) < 0.3
        adj[:, 0] = False
        out = torch.empty_like(q)
        seed_on_card = torch.tensor(seed, device=dev)  # the kernels read the seed from device memory
        want = session_attention_reference(q, k, v, adj, HEADS, p_drop, seed)
        qh, kh, vh = (t.view(B, N, HEADS, d).transpose(1, 2) for t in (q, k, v))
        sdpa = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=adj[:, None], dropout_p=p_drop))
        for name, lib in libs.items():
            fn = lib.session_attention_forward_variant
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            row = {"variant": name, "B": B, "N": N, "library_ms": sdpa}
            for staged, batch in ((1, B), (0, B), (0, 1)):
                def run():
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), adj.data_ptr(), out.data_ptr(), batch, N,
                             HEADS, d, math.sqrt(d), 1.0 - p_drop, keep_threshold(p_drop), seed_on_card.data_ptr(),
                             staged,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")

                out.zero_()
                run()
                torch.cuda.synchronize()
                key = ("staged" if staged else "warp") + ("" if batch == B else f"_B{batch}")
                row[f"{key}_within_tolerance"] = torch.allclose(out[:batch], want[:batch], **ATTN_TOL)
                row[f"{key}_ms"] = device_ms(run)
            print(json.dumps(row), flush=True)


def time_backward(libs: dict, gen: torch.Generator) -> None:
    dev = torch.device("cuda")
    B, d, p_drop, seed = 512, DIM // HEADS, 0.1, 5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # density 0.3 as in the smoke test's checks, and at N = 56 the density of its training batches
    for N, density in ((56, 0.3), (56, 0.0025), (32, 0.3), (16, 0.3), (8, 0.3)):
        q, k, v, dout = (torch.randn(B, N, DIM, device=dev, generator=gen) for _ in range(4))
        adj = torch.rand(B, N, N, device=dev, generator=gen) < density
        adj[:, 0] = False
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        seed_on_card = torch.tensor(seed, device=dev)
        want = torch.autograd.grad(
            session_attention_reference(*leaves, adj, HEADS, p_drop, seed), leaves, dout)
        heads_first = [t.view(B, N, HEADS, d).transpose(1, 2) for t in (q, k, v, dout)]

        def library(backward: bool):
            ins = [t.detach().requires_grad_(backward) for t in heads_first[:3]]
            out = sdpa(*ins, attn_mask=adj[:, None], dropout_p=p_drop)
            if backward:
                torch.autograd.grad(out, ins, heads_first[3])

        library_ms = device_ms(lambda: library(True)) - device_ms(lambda: library(False))
        got = [torch.empty_like(q) for _ in range(3)]
        for name, lib in libs.items():
            fn = lib.session_attention_backward
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]

            def run():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), adj.data_ptr(), dout.data_ptr(),
                         *(t.data_ptr() for t in got), B, N, HEADS, d, math.sqrt(d), 1.0 - p_drop,
                         keep_threshold(p_drop), seed_on_card.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")

            for t in got:
                t.zero_()
            run()
            torch.cuda.synchronize()
            print(json.dumps({
                "variant": name, "B": B, "N": N, "density": density, "library_ms": library_ms,
                "within_tolerance": all(torch.allclose(g, w, **ATTN_GRAD_TOL) for g, w in zip(got, want)),
                "max_abs_err": max((g - w).abs().max().item() for g, w in zip(got, want)),
                "ms": device_ms(run),
            }), flush=True)


def time_lazy(libs: dict, gen: torch.Generator) -> None:
    """Each variant's library is put where the port's wrappers load theirs,
    so the wrappers' own argument marshalling drives it. Materialize runs on
    two states: phase 7's, and one like a table early in training (95 % of
    the rows never touched, their moments 0; every row 1,000 steps behind,
    so every catch-up runs all 64 terms)."""
    state, uid, _, _ = _lazy_inputs(gen, torch.float32)
    idle = [t.clone() for t in state]
    untouched = torch.rand(ROWS, device=state[0].device, generator=gen) < 0.95
    idle[1][untouched] = 0.0
    idle[2][untouched] = 0.0
    idle[3].zero_()
    wants = {}
    for label, start in (("", state), ("_idle", idle)):
        wants[label] = [t.clone() for t in start]
        lazy_adamw.materialize_reference(*wants[label], LAZY_COUNT, **ADAMW)
    want_rows = lazy_adamw.gather_catch_up_reference(*state, uid, LAZY_COUNT, **ADAMW)
    count_row = step_row(LAZY_COUNT)  # a timed graph reads the count from the card
    work = [t.clone() for t in state]

    def restore(start):
        for dst, src in zip(work, start):
            dst.copy_(src)

    for name, lib in libs.items():
        _build._libs["lazy_adamw"] = lib
        row = {"variant": name}
        for label, start in (("", state), ("_idle", idle)):
            restore(start)
            lazy_adamw.materialize(*work, LAZY_COUNT, **ADAMW)
            torch.cuda.synchronize()
            want = wants[label]
            row[f"within_tolerance{label}"] = bool(torch.allclose(work[0], want[0], **TABLE_TOL))
            row[f"moments_equal{label}"] = all(torch.equal(a, b) for a, b in zip(work[1:], want[1:]))
            row[f"max_abs_err{label}"] = (work[0] - want[0]).abs().max().item()
            row[f"tol_ratio{label}"] = tol_ratio(work[0], want[0])
            row[f"materialize_ms{label}"] = reset_ms(
                lambda: lazy_adamw.materialize(*work, LAZY_COUNT, **ADAMW), lambda: restore(start), 10)
        rows = lazy_adamw.gather_catch_up(*state, uid, LAZY_COUNT, **ADAMW)
        torch.cuda.synchronize()
        row["gather_within_tolerance"] = bool(torch.allclose(rows[0], want_rows[0], **TABLE_TOL))
        row["gather_tol_ratio"] = tol_ratio(rows[0], want_rows[0])
        row["gather_ms"] = device_ms(lambda: lazy_adamw.gather_catch_up(*state, uid, count_row, **ADAMW), 10, 5)
        print(json.dumps(row), flush=True)
    _build._libs.pop("lazy_adamw")


def main() -> int:
    if len(sys.argv) not in (2, 3) or sys.argv[1] not in SOURCES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    print(nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    given = sys.argv[2] if len(sys.argv) == 3 else "{}"
    variants = {"shipped": [], **json.loads(Path(given).read_text() if given.endswith(".json") else given)}
    source, kernel_tag = SOURCES[sys.argv[1]]
    libs = build_variants(source, kernel_tag, variants)
    gen = torch.Generator(device="cuda").manual_seed(0)
    {"score": time_scoring, "attn": time_attention, "bwd": time_backward, "lazy": time_lazy}[sys.argv[1]](libs, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
