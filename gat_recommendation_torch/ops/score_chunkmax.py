"""Full-catalog scores plus per-chunk maxes: phase 1 of the exact top-k.

``scores[b, c] = sess[b]·table[c]``, set to -inf for phantom columns
(``c >= num_items``) and for excluded columns (``exclude[b, c]``: the seen
items and the padding row when serving), plus ``maxes[b, g]``, the max of
each 32-column chunk. Phase 2 (``ops/scoring.py``) selects from these.

``score_chunkmax`` is the wrapper: on CUDA tensors it launches a
hand-written kernel of ``csrc/score_chunkmax.cu`` (which replaces the JAX
package's Pallas kernel ``ops/pallas/score_chunkmax.py::fused_score_chunkmax``)
or raises; on CPU tensors it runs the plain version
``score_chunkmax_reference``. Maxes are ``[B, V/32]``; the Pallas kernel
returns them transposed (``[V/32, B]``).

The source holds two kernels and chooses by the batch: one warp per chunk
looping over the sessions (serving, B = 1), and a register-tiled product with
the mask and the chunk max in its epilogue (evaluation batches).
``score_chunkmax.launches`` counts every launch, ``score_chunkmax.tile_launches``
those that went to the tiled kernel. ``score_chunkmax_variant`` names the
kernel itself; it exists for measuring the two against each other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gat_recommendation_torch.ops import _build

CHUNK = 32
MAX_DIM = 512  # four float4 slots per lane


def _exclude_rows(exclude: torch.Tensor | None, B: int, V: int) -> torch.Tensor | None:
    """The exclusion mask as [B, V]; a [V] mask is accepted when B == 1."""
    if exclude is None:
        return None
    if exclude.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"exclude must be bool or uint8, got {exclude.dtype}")
    if exclude.shape == (V,) and B == 1:
        return exclude.reshape(1, V)
    if exclude.shape != (B, V):
        raise ValueError(f"exclude: expected {(B, V)} (or ({V},) when B == 1), got {tuple(exclude.shape)}")
    return exclude


def _valid_columns(V: int, num_items: int | None) -> int:
    return V if num_items is None else min(num_items, V)


def masked_scores(
    sess: torch.Tensor,
    table: torch.Tensor,
    num_items: int | None = None,
    exclude: torch.Tensor | None = None,
) -> torch.Tensor:
    """``sess @ table.T`` [B, V] with phantom and excluded columns at -inf."""
    B, V = sess.shape[0], table.shape[0]
    exclude = _exclude_rows(exclude, B, V)
    keep = (torch.arange(V, device=sess.device) < _valid_columns(V, num_items)).expand(B, V)
    if exclude is not None:
        keep = keep & ~exclude.bool()
    scores = sess @ table.T
    return torch.where(keep, scores, torch.full_like(scores, -math.inf))


def score_chunkmax_reference(
    sess: torch.Tensor,
    table: torch.Tensor,
    num_items: int | None = None,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (scores [B, V] f32, maxes [B, V/32] f32)."""
    B, V = sess.shape[0], table.shape[0]
    if V % CHUNK:
        raise ValueError(f"V={V} rows must be a multiple of {CHUNK}")
    scores = masked_scores(sess, table, num_items, exclude)
    return scores, scores.view(B, V // CHUNK, CHUNK).amax(dim=-1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("score_chunkmax")
    fn = lib.score_chunkmax_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    forced = lib.score_chunkmax_forward_variant
    forced.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    forced.restype = ctypes.c_int
    lib.score_chunkmax_tile_min_batch.argtypes = []
    lib.score_chunkmax_tile_min_batch.restype = ctypes.c_int
    return lib


def score_chunkmax(
    sess: torch.Tensor,
    table: torch.Tensor,
    num_items: int | None = None,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked scores [B, V] and their 32-column chunk maxes [B, V/32], float32.

    sess: [B, D] float32; table: [V, D] float32 with V % 32 == 0;
    exclude: optional [B, V] (or [V] when B == 1) bool/uint8 mask of columns
    to set to -inf.
    """
    if sess.device.type == "cpu":
        return score_chunkmax_reference(sess, table, num_items, exclude)
    return _launch(sess, table, num_items, exclude, None)


def score_chunkmax_variant(
    sess: torch.Tensor,
    table: torch.Tensor,
    num_items: int | None,
    exclude: torch.Tensor | None,
    variant: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``score_chunkmax`` on CUDA tensors through the named kernel, ``"warp"``
    (one warp per chunk, a loop over the sessions) or ``"tile"`` (the tiled
    product), whatever the batch. For measuring the crossover between the
    two; the port itself calls ``score_chunkmax``."""
    if variant not in ("warp", "tile"):
        raise ValueError(f"variant must be 'warp' or 'tile', got {variant!r}")
    return _launch(sess, table, num_items, exclude, variant)


def _launch(sess, table, num_items, exclude, variant: str | None):
    """Check the arguments and launch; `variant` None lets the source choose by B."""
    if sess.device.type != "cuda":
        raise ValueError(f"score_chunkmax runs on cuda or cpu tensors, got {sess.device}")
    B, D = sess.shape
    V = table.shape[0]
    for name, t in (("sess", sess), ("table", table)):
        if t.dtype != torch.float32 or t.device != sess.device:
            raise ValueError(f"{name}: expected float32 on {sess.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if table.shape[1] != D or D % 4 or not 4 <= D <= MAX_DIM:
        raise ValueError(f"dim {D} vs table {tuple(table.shape)}: need equal, a multiple of 4, <= {MAX_DIM}")
    if V % CHUNK:
        raise ValueError(f"V={V} rows must be a multiple of {CHUNK}")
    exclude = _exclude_rows(exclude, B, V)
    if exclude is not None and (exclude.device != sess.device or not exclude.is_contiguous()):
        raise ValueError("exclude must be contiguous on the same device as sess")
    scores = torch.empty((B, V), dtype=torch.float32, device=sess.device)
    maxes = torch.empty((B, V // CHUNK), dtype=torch.float32, device=sess.device)
    lib = _lib()
    args = (
        sess.data_ptr(), table.data_ptr(),
        None if exclude is None else exclude.data_ptr(),
        scores.data_ptr(), maxes.data_ptr(),
        B, V, D, _valid_columns(V, num_items),
    )
    with torch.cuda.device(sess.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant is None:
            tile = B >= lib.score_chunkmax_tile_min_batch()
            err = lib.score_chunkmax_forward(*args, stream)
        else:
            tile = variant == "tile"
            err = lib.score_chunkmax_forward_variant(*args, int(tile), stream)
    _build.check(err, "score_chunkmax")
    score_chunkmax.launches += 1
    score_chunkmax.tile_launches += int(tile)
    return scores, maxes


score_chunkmax.launches = 0
score_chunkmax.tile_launches = 0
