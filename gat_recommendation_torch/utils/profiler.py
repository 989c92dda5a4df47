"""Wall-clock timers, device memory and profiler traces."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def timer(name: str = "block", logger=None, results: dict | None = None) -> Iterator[dict]:
    """Time a block; optionally log it and record it in ``results[name]`` (seconds)."""
    record: dict = {"name": name, "seconds": None}
    start = time.perf_counter()
    try:
        yield record
    finally:
        record["seconds"] = time.perf_counter() - start
        if results is not None:
            results[name] = record["seconds"]
        if logger is not None:
            logger.info(f"{name}: {record['seconds']:.4f}s")


def measure_memory(device=None) -> dict:
    """Device memory in MB (``allocated_mb``, ``peak_mb``, ``limit_mb``) from
    ``torch.cuda.memory_stats``. On the CPU (`device` "cpu", or no CUDA
    device) there is no allocator to read: zeros, and a ``note`` saying so."""
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda":
        return {"allocated_mb": 0.0, "peak_mb": 0.0, "limit_mb": 0.0,
                "note": "no device allocator on the CPU"}
    stats = torch.cuda.memory_stats(device)
    scale = 1.0 / (1024 * 1024)
    return {
        "allocated_mb": stats.get("allocated_bytes.all.current", 0) * scale,
        "peak_mb": stats.get("allocated_bytes.all.peak", 0) * scale,
        "limit_mb": torch.cuda.get_device_properties(device).total_memory * scale,
    }


@contextlib.contextmanager
def trace(log_dir: str | None = None) -> Iterator[None]:
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    card) written to `log_dir` for TensorBoard; nothing without `log_dir`."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
