"""The C++ batch engine (``native/batcher.cpp``), built at first use and bound with ctypes.

``available()`` builds ``native/batcher.cpp`` with ``g++ -O3 -march=native
-fPIC -shared`` into ``build/torch_native/libbatcher-<key>.so`` at the repo
root and loads it. The key hashes the source, the flags and the host's CPU
(``-march=native`` code must not run on another CPU), so an edited source or
another host builds anew and an unchanged one is reused. The build is safe
when several processes start it at once: each takes an exclusive lock on a
file beside the libraries, builds under a temporary name and renames it into
place, so every process loads one complete library. Without a C++ compiler
``available()`` is False and ``iterate_batches(engine="auto")`` takes the
numpy engine, as the JAX package's does; ``engine="native"`` then raises.

``build_csr`` and ``assemble_batch`` are the engine's two entry points. The
engine draws negatives from a SplitMix64 stream per slot, keyed by (batch
seed, global slot), not from the numpy engine's PCG substreams; everything
else in a batch equals the numpy engine's.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()  # batches may be assembled from several threads
_lib = None
_failed = False  # a build or load failed in this process; available() does not retry


def _host_key() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
        return "\n".join(sorted({ln for ln in lines if ln.startswith(("model name", "flags"))})).encode()
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _host_key()).hexdigest()
    return Path(build_dir) / f"libbatcher-{digest[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """The engine's library for this source and host, compiled first if it is
    missing. Raises with the compiler's output if the build fails."""
    target = library_path(build_dir)
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found; the C++ batch engine cannot be built")
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if target.exists():  # another process built it while this one waited
            return target
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed to build the C++ batch engine:\n{out.stdout}{out.stderr}")
        os.replace(tmp, target)
    return target


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p, i32p, u8p = (ctypes.POINTER(t) for t in (ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8))
    i64 = ctypes.c_int64
    lib.build_csr.restype = None
    lib.build_csr.argtypes = [i64p, i64p, i64, i64, i64p, i32p]
    lib.assemble_batch.restype = None
    lib.assemble_batch.argtypes = [
        i64p, i64p,  # the dataset's flat items and per-session offsets
        i64p, i64, i64,  # selected session indices, their count, batch size
        i64p, i32p, i64,  # CSR indptr, indices, num_items
        i64, i64, ctypes.c_uint64, i64,  # bucket_n, num_negatives, seed, slot_offset
        i32p, u8p, u8p, i32p, i32p, i32p, u8p,  # the seven output fields
    ]
    return lib


def load() -> ctypes.CDLL:
    """The engine's loaded library, building it at the first call. Raises if
    it cannot be built."""
    global _lib, _failed
    with _lock:
        if _lib is None:
            try:
                _lib = _typed(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError, subprocess.TimeoutExpired):
                _failed = True
                raise
        return _lib


def available() -> bool:
    """Whether the engine builds and loads on this host (builds it if needed)."""
    if _lib is None and not _failed:
        try:
            load()
        except (RuntimeError, OSError, subprocess.TimeoutExpired):
            pass
    return _lib is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_csr(item_i, item_j, num_items: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR of the directed edges item_i -> item_j: (indptr int64 [V+1],
    indices int32 [E]), each row sorted (duplicates kept)."""
    lib = load()
    item_i = np.ascontiguousarray(item_i, dtype=np.int64)
    item_j = np.ascontiguousarray(item_j, dtype=np.int64)
    indptr = np.zeros(num_items + 1, dtype=np.int64)
    indices = np.zeros(len(item_i), dtype=np.int32)
    lib.build_csr(_ptr(item_i, ctypes.c_int64), _ptr(item_j, ctypes.c_int64), len(item_i), num_items,
                  _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32))
    return indptr, indices


def assemble_batch(dataset, chunk, batch_size: int, bucket_n: int, seed: int, slot_offset: int = 0):
    """One fixed-shape ``SessionBatch`` (torch tensors on the CPU) of the
    sessions `chunk` (dataset indices), padded with empty slots to
    `batch_size`. `seed` is the batch's engine seed; `slot_offset` the global
    slot of local row 0, which keys each slot's negative stream."""
    import torch

    from gat_recommendation_torch.data.batching import SessionBatch

    lib = load()
    sess_idx = np.ascontiguousarray(chunk, dtype=np.int64)
    K = dataset.num_negatives
    out = (
        np.zeros((batch_size, bucket_n), dtype=np.int32),  # node_ids
        np.zeros((batch_size, bucket_n), dtype=np.uint8),  # node_mask
        np.zeros((batch_size, bucket_n, bucket_n), dtype=np.uint8),  # adj
        np.zeros(batch_size, dtype=np.int32),  # num_nodes
        np.zeros(batch_size, dtype=np.int32),  # targets
        np.zeros((batch_size, K), dtype=np.int32),  # negatives
        np.zeros(batch_size, dtype=np.uint8),  # sample_mask
    )
    lib.assemble_batch(
        _ptr(dataset.items, ctypes.c_int64), _ptr(dataset.offsets, ctypes.c_int64),
        _ptr(sess_idx, ctypes.c_int64), len(sess_idx), batch_size,
        _ptr(dataset.graph.indptr, ctypes.c_int64), _ptr(dataset.graph.indices, ctypes.c_int32),
        dataset.num_items, bucket_n, K, ctypes.c_uint64(seed), ctypes.c_int64(slot_offset),
        *(_ptr(a, ctypes.c_uint8 if a.dtype == np.uint8 else ctypes.c_int32) for a in out),
    )
    return SessionBatch(*(torch.from_numpy(a.view(np.bool_) if a.dtype == np.uint8 else a) for a in out))
