"""Session attention: masked multi-head attention over each session's adjacency.

The attention core of ``TransformerConv`` (``models/layers.py``): per session
and head, ``q·kᵀ/√d`` over sources, masked by ``adj[b, dst, src]``, softmax
over sources with all-masked rows giving zeros, attention dropout on the
weights in train mode (kept weights scaled by ``1/(1-p)`` AFTER the softmax),
weights times ``v``.

``session_attention`` is the wrapper: on a CUDA tensor it launches the
hand-written kernels of ``csrc/session_attention.cu`` (which replace the JAX
package's Pallas kernel ``ops/pallas/session_attention.py::
fused_session_attention``) or raises; on a CPU tensor it runs the plain
version ``session_attention_reference``, which autograd differentiates. On
the card the forward and the backward are one ``torch.autograd.Function``:
the forward saves only its inputs and the backward kernel recomputes the
scores, the row max and the row sum.

The dropout keep bit of weight ``(b, h, i, j)`` is a pure function of
``(seed, b, h, i, j)``: ``counter_hash(seed, linear index) >> 8`` below
``(1-p)·2^24`` (``ops/rounding.py``). No mask tensor is stored; the kernels
and the plain version draw the same bits from the same seed.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gat_recommendation_torch.ops import _build
from gat_recommendation_torch.ops.masked import masked_softmax
from gat_recommendation_torch.ops.rounding import counter_hash

MAX_NODES = 64  # two sources per lane of one warp
MAX_HEAD_DIM = 128  # four output columns per lane
_KEEP_ALL = 1 << 24


def keep_threshold(dropout_p: float) -> int:
    """The 24-bit integer below which a weight's random value keeps it."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    return _KEEP_ALL if dropout_p == 0.0 else round((1.0 - dropout_p) * _KEEP_ALL)


def dropout_keep_mask(shape: tuple[int, int, int, int], dropout_p: float, seed: int, device) -> torch.Tensor:
    """The [B, H, N, N] bool keep mask that the kernels regenerate from `seed`."""
    idx = torch.arange(math.prod(shape), device=device).view(shape)
    return (counter_hash(seed, idx) >> 8) < keep_threshold(dropout_p)


def session_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    adj: torch.Tensor,
    heads: int,
    dropout_p: float = 0.0,
    seed: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version. q/k/v: [B, N, heads*d]; adj: [B, N, N] bool.
    With ``dropout_p > 0`` the keep mask comes from `seed`."""
    B, N, HD = q.shape
    d = HD // heads
    qr, kr, vr = (t.reshape(B, N, heads, d) for t in (q, k, v))
    scores = torch.einsum("bihd,bjhd->bhij", qr, kr) / math.sqrt(d)
    alpha = masked_softmax(scores, adj[:, None, :, :].bool(), dim=-1)
    if dropout_p > 0.0:
        if seed is None:
            raise ValueError("attention dropout needs a seed")
        keep = dropout_keep_mask((B, heads, N, N), dropout_p, seed, q.device)
        alpha = torch.where(keep, alpha / (1.0 - dropout_p), torch.zeros_like(alpha))
    return torch.einsum("bhij,bjhd->bihd", alpha, vr).reshape(B, N, HD)


def _lib() -> ctypes.CDLL:
    lib = _build.load("session_attention")
    tail = [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_void_p,
    ]
    lib.session_attention_forward.argtypes = [ctypes.c_void_p] * 5 + tail
    lib.session_attention_forward.restype = ctypes.c_int
    lib.session_attention_backward.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.session_attention_backward.restype = ctypes.c_int
    return lib


class _SessionAttention(torch.autograd.Function):
    """Forward and backward kernels of csrc/session_attention.cu."""

    @staticmethod
    def forward(ctx, q, k, v, adj, heads: int, dropout_p: float, seed: int):
        B, N, HD = q.shape
        d = HD // heads
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            err = _lib().session_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), adj.data_ptr(), out.data_ptr(),
                B, N, heads, d, math.sqrt(d), 1.0 - dropout_p, keep_threshold(dropout_p), seed,
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(err, "session_attention")
        session_attention.launches += 1
        ctx.save_for_backward(q, k, v, adj)
        ctx.args = (heads, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, adj = ctx.saved_tensors
        dq, dk, dv = session_attention_backward(q, k, v, adj, grad_out, *ctx.args)
        return dq, dk, dv, None, None, None, None


def session_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    adj: torch.Tensor,
    grad_out: torch.Tensor,
    heads: int,
    dropout_p: float = 0.0,
    seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``session_attention`` for the output gradient `grad_out`.

    What the autograd function calls; the inputs are the forward's, already
    checked there. On CUDA tensors it launches the backward kernel, which
    recomputes the softmax and the dropout bits; on CPU tensors autograd
    differentiates the plain version.
    """
    if q.device.type == "cpu":
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = session_attention_reference(*leaves, adj, heads, dropout_p, seed)
        return torch.autograd.grad(out, leaves, grad_out)
    B, N, HD = q.shape
    d = HD // heads
    grad_out = grad_out.contiguous()
    if grad_out.shape != q.shape or grad_out.dtype != torch.float32 or grad_out.data_ptr() % 16:
        raise ValueError(f"grad_out: expected float32 {tuple(q.shape)}, 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().session_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), adj.data_ptr(), grad_out.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, N, heads, d, math.sqrt(d), 1.0 - dropout_p, keep_threshold(dropout_p), seed,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "session_attention_backward")
    session_attention.backward_launches += 1
    return dq, dk, dv


def session_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    adj: torch.Tensor,
    heads: int,
    dropout_p: float = 0.0,
    seed: int | None = None,
) -> torch.Tensor:
    """Masked multi-head attention; destinations with no in-edges output zeros.

    q/k/v: [B, N, heads*d] float32; adj: [B, N, N] bool or uint8
    (adj[b, dst, src]). `dropout_p` > 0 applies attention dropout keyed by
    the 64-bit `seed`; 0 is the eval path. Returns [B, N, heads*d] float32,
    differentiable with respect to q, k and v.
    """
    if dropout_p > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    seed = 0 if seed is None else seed & 0xFFFFFFFFFFFFFFFF
    if q.device.type == "cpu":
        return session_attention_reference(q, k, v, adj, heads, dropout_p, seed)
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
    keep_threshold(dropout_p)  # validates the rate before anything launches
    return _SessionAttention.apply(q, k, v, adj, heads, dropout_p, seed)


session_attention.launches = 0
session_attention.backward_launches = 0
