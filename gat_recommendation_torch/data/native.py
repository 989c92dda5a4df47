"""The port's C++ library: the batch engine (``native/batcher.cpp``) and the
int8 candidate scorer (``native/scorer.cpp``), built at first use and bound
with ctypes.

``available()`` builds both sources with ``g++ -O3 -march=native -fPIC
-shared`` into one ``build/torch_native/libbatcher-<key>.so`` at the repo
root and loads it. The key hashes both sources, the flags and the host's CPU
(``-march=native`` code must not run on another CPU), so an edited source or
another host builds anew and an unchanged one is reused. The build is safe
when several processes start it at once: each takes an exclusive lock on a
file beside the libraries, builds under a temporary name and renames it into
place, so every process loads one complete library. Without a C++ compiler
``available()`` is False and ``iterate_batches(engine="auto")`` takes the
numpy engine, as the JAX package's does; ``engine="native"`` then raises.

``build_csr`` and ``assemble_batch`` are the engine's two entry points, and
``pack_bits`` bit-packs a batch's adjacency for its copy to the card
(``data/batching.py::pack_adj``) without holding the interpreter lock. The
engine draws negatives from a SplitMix64 stream per slot, keyed by (batch
seed, global slot), not from the numpy engine's PCG substreams; everything
else in a batch equals the numpy engine's.

``quantize_table`` and ``score_int8_topl`` are the scorer's: the serving
``Recommender``'s int8 path on a CPU host. ``load_scorer_variant("avx2")``
builds the same sources pinned to the scorer's AVX2 path (``-mavx2
-mno-avx512f``), so tests reach that path on a host with AVX-512 VNNI.
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

SOURCES = tuple(Path(__file__).resolve().parents[1] / "native" / name for name in ("batcher.cpp", "scorer.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
# Test-only builds that pin one path of the scorer's dot product.
VARIANT_FLAGS = {"avx2": ("-O3", "-mavx2", "-mno-avx512f", "-fPIC", "-shared", "-std=c++17", "-Wall")}

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


def library_path(build_dir: Path = BUILD_DIR, flags: tuple = CXX_FLAGS) -> Path:
    key = b"".join(src.read_bytes() for src in SOURCES) + " ".join(flags).encode() + _host_key()
    return Path(build_dir) / f"libbatcher-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR, flags: tuple = CXX_FLAGS) -> Path:
    """The library for these sources, flags and host, compiled first if it is
    missing. Raises with the compiler's output if the build fails."""
    target = library_path(build_dir, flags)
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
        out = subprocess.run([cxx, *flags, "-o", str(tmp), *map(str, SOURCES)],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cxx} failed to build the C++ batch engine and int8 scorer:\n{out.stdout}{out.stderr}")
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
    lib.pack_bits.restype = None
    lib.pack_bits.argtypes = [u8p, i64, i64, u8p]  # rows of n bytes -> rows of ceil(n / 8) bytes
    f32p, i8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int8)
    lib.quantize_table.restype = None
    lib.quantize_table.argtypes = [f32p, i64, ctypes.c_int32, i8p, f32p, i32p]  # table V D -> q scale rowsum
    lib.score_int8_topl.restype = None
    lib.score_int8_topl.argtypes = [
        i8p, f32p, i32p, i64, ctypes.c_int32,  # q, scale, rowsum, V, D
        i8p, ctypes.c_float, u8p,  # the session quantized, its scale, the seen mask [V] or NULL
        ctypes.c_int32, ctypes.c_int32, i64p, f32p,  # L, n_threads, out_idx [L], out_score [L]
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


def load_scorer_variant(target: str) -> ctypes.CDLL:
    """The library built with the flags of `target` (``"avx2"``: the scorer's
    AVX2 dot product on any x86 host), for tests; pass it as ``lib=`` to
    ``quantize_table`` and ``score_int8_topl``. Raises if it cannot be built."""
    if target not in VARIANT_FLAGS:
        raise ValueError(f"unknown scorer variant {target!r}; known: {sorted(VARIANT_FLAGS)}")
    return _typed(ctypes.CDLL(str(build(flags=VARIANT_FLAGS[target]))))


def available() -> bool:
    """Whether the engine builds and loads on this host (builds it if needed)."""
    if _lib is None and not _failed:
        try:
            load()
        except (RuntimeError, OSError, subprocess.TimeoutExpired):
            pass
    return _lib is not None


def _ptr(a: np.ndarray, ctype):
    # Not ``a.ctypes.data_as``: the pointer it casts refers to itself, so
    # every call would leave a reference cycle for the garbage collector.
    return ctypes.pointer(ctype.from_address(a.ctypes.data))


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


def pack_bits(adj: np.ndarray) -> np.ndarray:
    """``np.packbits(adj, axis=-1)`` of a bool (or 0/1 uint8) array in the
    C++ library: [..., n] -> [..., ceil(n / 8)] uint8, most significant bit
    first. ctypes releases the interpreter lock for the call."""
    lib = load()
    bits = np.ascontiguousarray(adj).view(np.uint8)
    n = bits.shape[-1]
    out = np.empty((*bits.shape[:-1], (n + 7) // 8), dtype=np.uint8)
    lib.pack_bits(_ptr(bits, ctypes.c_uint8), bits.size // max(n, 1), n, _ptr(out, ctypes.c_uint8))
    return out


# -- the serving-side int8 scorer (native/scorer.cpp) ------------------------


def quantize_table(table: np.ndarray, lib: ctypes.CDLL | None = None):
    """Per-row int8 quantization of a [V, D] float32 table: (q int8 [V, D],
    scale float32 [V], rowsum int32 [V]). Row i dequantizes as q[i] * scale[i],
    scale[i] = max|row| / 127 (0 for an all-zero row); rowsum feeds the
    unsigned-bias correction of ``score_int8_topl``."""
    lib = lib if lib is not None else load()
    table = np.ascontiguousarray(table, dtype=np.float32)
    V, D = table.shape
    q = np.empty((V, D), np.int8)
    scale = np.empty(V, np.float32)
    rowsum = np.empty(V, np.int32)
    lib.quantize_table(_ptr(table, ctypes.c_float), V, D, _ptr(q, ctypes.c_int8),
                       _ptr(scale, ctypes.c_float), _ptr(rowsum, ctypes.c_int32))
    return q, scale, rowsum


def score_int8_topl(q: np.ndarray, scale: np.ndarray, rowsum: np.ndarray, sess: np.ndarray, L: int,
                    seen: np.ndarray | None = None, n_threads: int = 2, lib: ctypes.CDLL | None = None):
    """The top-L rows of `q` by approximate (int8) dot score with the float32
    query `sess` [D], quantized here with scale max|sess| / 127: (idx int64
    [<= L], approx_score float32) in no particular order. Rows with
    seen[i] (a uint8 [V] mask) or scale 0 are never candidates. Callers
    re-rank the candidates exactly in float32 (``serving/recommender.py``)."""
    lib = lib if lib is not None else load()
    V, D = q.shape
    for name, a, dtype, shape in (("q", q, np.int8, (V, D)), ("scale", scale, np.float32, (V,)),
                                  ("rowsum", rowsum, np.int32, (V,))):
        if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous:
            raise ValueError(f"{name}: expected a contiguous {np.dtype(dtype)} array of shape {shape}")
    if seen is not None and (seen.dtype != np.uint8 or seen.shape != (V,) or not seen.flags.c_contiguous):
        raise ValueError(f"seen: expected a contiguous uint8 array of shape ({V},)")
    sess = np.ascontiguousarray(sess, dtype=np.float32).reshape(D)
    s_sess = float(np.abs(sess).max()) / 127.0
    sess_q = np.round(sess / s_sess).clip(-127, 127).astype(np.int8) if s_sess > 0 else np.zeros(D, np.int8)
    out_idx = np.empty(L, np.int64)
    out_score = np.empty(L, np.float32)
    lib.score_int8_topl(
        _ptr(q, ctypes.c_int8), _ptr(scale, ctypes.c_float), _ptr(rowsum, ctypes.c_int32), V, D,
        _ptr(sess_q, ctypes.c_int8), ctypes.c_float(s_sess), None if seen is None else _ptr(seen, ctypes.c_uint8),
        L, n_threads, _ptr(out_idx, ctypes.c_int64), _ptr(out_score, ctypes.c_float),
    )
    keep = out_idx >= 0
    return out_idx[keep], out_score[keep]
