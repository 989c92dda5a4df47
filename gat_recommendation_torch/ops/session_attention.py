"""Session attention: masked multi-head attention over each session's adjacency.

The attention core of ``TransformerConv`` (``models/layers.py``): per session
and head, ``q·kᵀ/√d`` over sources, masked by ``adj[b, dst, src]``, softmax
over sources with all-masked rows giving zeros, weights times ``v``.

``session_attention`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/session_attention.cu`` (which replaces the JAX
package's Pallas kernel ``ops/pallas/session_attention.py::
fused_session_attention``) or raises; on a CPU tensor it runs the plain
version ``session_attention_reference``. Forward only: the backward and the
attention dropout arrive with the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gat_recommendation_torch.ops import _build
from gat_recommendation_torch.ops.masked import masked_softmax

MAX_NODES = 64  # two sources per lane of one warp
MAX_HEAD_DIM = 128  # four output columns per lane


def session_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, adj: torch.Tensor, heads: int
) -> torch.Tensor:
    """Plain PyTorch version. q/k/v: [B, N, heads*d]; adj: [B, N, N] bool."""
    B, N, HD = q.shape
    d = HD // heads
    qr, kr, vr = (t.reshape(B, N, heads, d) for t in (q, k, v))
    scores = torch.einsum("bihd,bjhd->bhij", qr, kr) / math.sqrt(d)
    alpha = masked_softmax(scores, adj[:, None, :, :].bool(), dim=-1)
    return torch.einsum("bhij,bjhd->bihd", alpha, vr).reshape(B, N, HD)


def _lib() -> ctypes.CDLL:
    lib = _build.load("session_attention")
    fn = lib.session_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def session_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, adj: torch.Tensor, heads: int
) -> torch.Tensor:
    """Masked multi-head attention; destinations with no in-edges output zeros.

    q/k/v: [B, N, heads*d] float32; adj: [B, N, N] bool or uint8
    (adj[b, dst, src]). Returns [B, N, heads*d] float32.
    """
    if q.device.type == "cpu":
        return session_attention_reference(q, k, v, adj, heads)
    if q.device.type != "cuda":
        raise ValueError(f"session_attention runs on cuda or cpu tensors, got {q.device}")
    B, N, HD = q.shape
    d = HD // heads if heads > 0 else 0
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name}: expected float32 {tuple(q.shape)} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if adj.shape != (B, N, N) or adj.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"adj: expected bool/uint8 {(B, N, N)}, got {adj.dtype} {tuple(adj.shape)}")
    if adj.device != q.device or not adj.is_contiguous():
        raise ValueError("adj must be contiguous on the same device as q")
    if heads < 1 or HD != heads * d or d % 4 or not 4 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim={HD}/{heads} must be a multiple of 4 in [4, {MAX_HEAD_DIM}]")
    if not 1 <= N <= MAX_NODES:
        raise ValueError(f"N={N} nodes; the kernel takes 1..{MAX_NODES}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().session_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), adj.data_ptr(), out.data_ptr(),
            B, N, heads, d, math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "session_attention")
    session_attention.launches += 1
    return out


session_attention.launches = 0
