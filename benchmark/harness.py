"""One run of one cell: set-up, the measured window, the check, the result line.

The cell's parts are found by name (``benchmark/__init__.py``). The entry a
traffic file names (``entries/<entry>.py``) builds the program's objects and
drives them; this module times the set-up and the window, reads the card's
peak memory, with ``--trace 1`` traces a short window first
(``yardstick/trace.py``) and then runs the measured window untraced, asks
each per-layer metric's reader (``metrics/<name>.py``) for its number, has
the entry judge the outputs against the reference once the program's state
is freed, and prints the earlier lines and the last one.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gat_recommendation_tpu")
TRACE_SECONDS = 3.0  # the traced window: whole epochs or passes until this long


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def load_module(path: Path):
    """A module from a file of this benchmark, by path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_part_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, limits,
    and the names of the metrics it reports."""

    def __init__(self, manifest: dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        w = cells[name]
        self.name, self.chips = name, int(w["chips"])
        conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        self.config = read_json(here.parent / conf["file"])
        self.traffic = read_json(here / "traffic" / f"{w['traffic']}.json")
        self.limits = read_json(here / "limits" / f"{name}.json")
        self.entry = here / "entries" / f"{self.traffic['entry']}.py"

        def mine(m: dict) -> bool:
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"] if mine(m) and m["moves"] in moved]
        self.metric_files = {m["name"]: here / "metrics" / f"{m['name']}.py" for m in self.per_layer}


class SetupClock:
    """Seconds since the process started, and the set-up's parts by name."""

    def __init__(self, start: float):
        self.start = start
        self.parts: dict[str, float] = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t

    def elapsed(self) -> float:
        return time.perf_counter() - self.start


def nvidia_smi() -> str:
    query = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({type(e).__name__})"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def within(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float) -> dict:
    """Run `cell` once and return the result line's object (the check's
    numbers last). With `trace` the per-layer metrics replace the end-to-end
    ones: a traced window (the card's activity, where there is a card, and
    the observer's counts of the batches) comes first, then the measured
    window as a `--trace 0` run has it, untraced and unobserved, whose rate
    the readers of the whole step's shares (MFU, idle) take, since the
    tracer slows the host."""
    import torch

    from benchmark.yardstick import trace as ytrace

    clock = SetupClock(start)
    entry = load_module(cell.entry)
    session = entry.Session(cell.config, cell.traffic, seed, device, clock, observe=trace)
    gc.collect()  # what the set-up left for the collector goes now, not in the window
    on_card = torch.device(device).type == "cuda"
    tracer = ytrace.Tracer() if trace and on_card else None
    if tracer is not None:
        tracer.arm()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock.elapsed()
    parts = ", ".join(f"{k} {v:.3f}" for k, v in clock.parts.items())
    log(f"setup_s {setup_s:.3f}: {parts}; graphs captured {session.graphs()}")
    windows = [session.window(min(seconds, TRACE_SECONDS), tracer, observe=True)] if trace else []
    window = session.window(seconds)
    windows.append(window)
    captured = sum(w.get("graphs_captured_in_window") or 0 for w in windows)
    if captured:
        log(f"graphs captured inside the window: {captured}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    result = {"correct": False, "attempted": sum(w["attempted"] for w in windows),
              "failed": sum(w["failed"] for w in windows), "metrics": {}}
    if trace:
        traced = windows[0]
        log(f"traced window: {json.dumps({k: v for k, v in traced.items() if k != 'metrics'})}")
        data = tracer.read() if tracer is not None else None
        if data is not None:  # the traced window's own time (its "seconds" also hold the trace's export)
            slowdown = (window["sessions"] / window["seconds"]) / (traced["sessions"] / data.window_s)
            log(f"the traced window ran {slowdown:.4f} times slower than the untraced one")
            log(f"trace: window_s {data.window_s:.4f}, busy_s {data.busy_s:.4f}, {len(data.device)} device "
                f"operations, {len(data.host)} CUDA calls on the stepping thread")
        obs = dict(session.observation(traced, data), untraced=window)
        for name, path in cell.metric_files.items():
            m = next(m for m in cell.per_layer if m["name"] == name)
            value = load_module(path).read(obs)
            if value is None:
                log(f"per-layer metric {name}: nothing to read in this run (left out)")
                continue
            result["metrics"][name] = {"value": value, "unit": m["unit"]}
        busy = data.busy_s if data is not None else None
        result["breakdown"] = data.breakdown() if data is not None else {"device_ops": [], "idle_gaps": []}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else window["metrics"].get(m["name"])
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"window: {json.dumps({k: v for k, v in window.items() if k != 'metrics'})}")
    outputs = session.close()  # what the check judges, on the host; the program's state is freed
    del session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, details = entry.check(cell.config, cell.traffic, seed, device, outputs)
    result["device"] = {"platform": "gpu" if on_card else torch.device(device).type,
                        "kind": torch.cuda.get_device_name() if on_card else "cpu",
                        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=busy, window_s=data.window_s if data is not None else None)
    result["correct"] = within(numbers, cell.limits)
    log(f"check details: {json.dumps(details)}")
    for k, v in numbers.items():
        log(f"check {k} {v!r} limit {cell.limits[k]!r}")
    result["checked"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    return result


def main(argv=None, start: float | None = None) -> int:
    start = time.perf_counter() if start is None else start
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell(read_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    log(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", start)
    found = forbidden_modules()
    if found:
        log(f"the process loaded {found}: the benchmark measures the port alone; no result")
        return 3
    print(json.dumps(result), flush=True)
    return 0
