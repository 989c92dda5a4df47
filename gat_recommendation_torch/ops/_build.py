"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, loaded with ``ctypes``. A library is keyed by a hash of its source,
the shared headers (``csrc/*.cuh``) and the compiler flags and lands in ``build/torch_kernels/`` at the repo root,
so an edited kernel rebuilds and an unchanged one is reused. ``build()``
starts one ``nvcc`` per missing library, all at once, and waits for them all.
A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("session_attention", "score_chunkmax", "embedding_adamw")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register and spill counts go to the build log
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNELS) -> float:
    """Compile every library in `names` that is not built yet, in parallel.

    Returns the wall seconds spent. Each compile writes to a temporary name
    and is renamed into place, so a concurrent or interrupted build never
    leaves a partial library under the final name. The compiler's output is
    kept beside the library as ``<lib>.log``.
    """
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in jobs:
        log, _ = proc.communicate()
        target.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, building it first if needed."""
    with _lock:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")
