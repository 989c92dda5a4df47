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

The source holds two forward kernels and chooses by the blocks the first
would need (``B * heads * ceil(N / 4)``: below 1024 up to 32 nodes, below 448
above; ``kStagedMinRowBlocks`` in the source): one warp per destination
row, four rows of a session and head to a block that stages K and V in shared
memory once for them (serving: even one session spreads over many SMs), and
one block per session and head (training and evaluation batches). The backward is one block per session and head with two
tile buffers, refilled as the passes go, so that two blocks share an SM.
``session_attention.launches`` counts every forward launch,
``session_attention.staged_launches`` those that went to the staged kernel,
``session_attention.backward_launches`` the backward's;
``packed_launches`` and ``packed_backward_launches`` those of them that read
the bit-packed adjacency.
``session_attention_variant`` names the forward kernel itself, and
``session_attention_launch_floor`` launches an empty kernel of the row
forward's grid; both exist for measuring only.

The dropout keep bit of weight ``(b, h, i, j)`` is a pure function of
``(seed, b0 + b, h, i, j)``: ``counter_hash(seed, linear index) >> 8`` below
``(1-p)·2^24`` (``ops/rounding.py``). ``b0`` (``first_session``) is 0 on one
GPU; under a mesh a data rank holds sessions ``[b0, b0 + B)`` of the global
batch (the active shard's, ``ops/shard.py``, by default) and draws at its
rows the bits the whole batch draws. It goes to the kernels by value. No mask tensor is stored; the kernels
and the plain version draw the same bits from the same seed. The kernels read
the seed from device memory: a 0-dim int64 tensor on the card (a layer's
field of the step block, ``ops/step_block.py``, so that a CUDA graph of the
train step replays every step with its own seed), or, for a Python int, a
one-element tensor the wrapper copies there.

The adjacency comes in two forms, named by the ``packed`` argument (never
guessed from the dtype: a dense adjacency may be bool or uint8): dense,
[B, N, N] bool or uint8 (serving builds it), or the bit-packed transfer form
of the training batches, [B, N, ceil(N / 8)] uint8, ``np.packbits`` of each
row (``data/batching.py::pack_adj``). The kernels read the packed rows
themselves and give the same bits as from the dense form; the plain version
unpacks them first (``ops/masked.py::unpack_adjacency``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from gat_recommendation_torch.ops import _build, shard, step_block
from gat_recommendation_torch.ops.masked import masked_softmax, unpack_adjacency
from gat_recommendation_torch.ops.rounding import keep_mask as dropout_keep_mask
from gat_recommendation_torch.ops.rounding import keep_threshold

MAX_NODES = 64  # two sources per lane of one warp
MAX_HEAD_DIM = 128  # one float4 of output columns per lane


def session_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    adj: torch.Tensor,
    heads: int,
    dropout_p: float = 0.0,
    seed: int | torch.Tensor | None = None,
    packed: bool = False,
    first_session: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version. q/k/v: [B, N, heads*d]; adj: [B, N, N] bool,
    or with `packed` the bit-packed rows [B, N, ceil(N / 8)] uint8. With
    ``dropout_p > 0`` the keep mask comes from `seed` (an int, or a 0-dim
    int64 tensor holding its bits), session b drawing the bits of session
    ``first_session + b``."""
    B, N, HD = q.shape
    if packed:
        adj = unpack_adjacency(adj, N)
    d = HD // heads
    qr, kr, vr = (t.reshape(B, N, heads, d) for t in (q, k, v))
    scores = torch.einsum("bihd,bjhd->bhij", qr, kr) / math.sqrt(d)
    alpha = masked_softmax(scores, adj[:, None, :, :].bool(), dim=-1)
    if dropout_p > 0.0:
        if seed is None:
            raise ValueError("attention dropout needs a seed")
        keep = dropout_keep_mask((B, heads, N, N), dropout_p, seed, q.device, first_session * heads * N * N)
        alpha = torch.where(keep, alpha / (1.0 - dropout_p), torch.zeros_like(alpha))
    return torch.einsum("bhij,bjhd->bihd", alpha, vr).reshape(B, N, HD)


def _lib() -> ctypes.CDLL:
    lib = _build.load("session_attention")
    tail = [ctypes.c_int] * 4 + [  # B, N, H, d; scale, keep_prob, threshold, seed, b0, stream
        ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    inputs = [ctypes.c_void_p] * 4 + [ctypes.c_int]  # q, k, v, adj and whether adj is packed
    lib.session_attention_forward.argtypes = inputs + [ctypes.c_void_p] + tail
    lib.session_attention_forward.restype = ctypes.c_int
    lib.session_attention_forward_variant.argtypes = (
        inputs + [ctypes.c_void_p] + tail[:-1] + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.session_attention_forward_variant.restype = ctypes.c_int
    lib.session_attention_takes_staged.argtypes = [ctypes.c_int] * 3
    lib.session_attention_takes_staged.restype = ctypes.c_int
    lib.session_attention_backward.argtypes = inputs + [ctypes.c_void_p] * 4 + tail
    lib.session_attention_launch_floor.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.session_attention_launch_floor.restype = ctypes.c_int
    lib.session_attention_backward.restype = ctypes.c_int
    return lib


class _SessionAttention(torch.autograd.Function):
    """Forward and backward kernels of csrc/session_attention.cu."""

    @staticmethod
    def forward(ctx, q, k, v, adj, heads: int, dropout_p: float, seed: torch.Tensor | None,
                variant: str | None, packed: bool, first_session: int):
        B, N, HD = q.shape
        d = HD // heads
        out = torch.empty_like(q)
        lib = _lib()
        args = (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), adj.data_ptr(), int(packed), out.data_ptr(),
            B, N, heads, d, math.sqrt(d), 1.0 - dropout_p, keep_threshold(dropout_p),
            None if seed is None else seed.data_ptr(), first_session,
        )
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            if variant is None:  # the source chooses by B, N and heads
                staged = bool(lib.session_attention_takes_staged(B, N, heads))
                err = lib.session_attention_forward(*args, stream)
            else:
                staged = variant == "staged"
                err = lib.session_attention_forward_variant(*args, int(staged), stream)
        _build.check(err, "session_attention")
        session_attention.launches += 1
        session_attention.staged_launches += int(staged)
        session_attention.packed_launches += int(packed)
        ctx.save_for_backward(q, k, v, adj)
        ctx.args = (heads, dropout_p, seed, packed, first_session)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, adj = ctx.saved_tensors
        dq, dk, dv = session_attention_backward(q, k, v, adj, grad_out, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def session_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    adj: torch.Tensor,
    grad_out: torch.Tensor,
    heads: int,
    dropout_p: float = 0.0,
    seed: int | torch.Tensor | None = 0,
    packed: bool = False,
    first_session: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``session_attention`` for the output gradient `grad_out`.

    What the autograd function calls; the inputs are the forward's, already
    checked there. On CUDA tensors it launches the backward kernel, which
    recomputes the softmax and the dropout bits; on CPU tensors autograd
    differentiates the plain version.
    """
    if q.device.type == "cpu":
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = session_attention_reference(*leaves, adj, heads, dropout_p, seed, packed, first_session)
        return torch.autograd.grad(out, leaves, grad_out)
    B, N, HD = q.shape
    d = HD // heads
    grad_out = grad_out.contiguous()
    if grad_out.shape != q.shape or grad_out.dtype != torch.float32 or grad_out.data_ptr() % 16:
        raise ValueError(f"grad_out: expected float32 {tuple(q.shape)}, 16-byte aligned")
    seed = _seed_on(q.device, dropout_p, seed)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().session_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), adj.data_ptr(), int(packed), grad_out.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, N, heads, d, math.sqrt(d), 1.0 - dropout_p, keep_threshold(dropout_p),
            None if seed is None else seed.data_ptr(), first_session, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "session_attention_backward")
    session_attention.backward_launches += 1
    session_attention.packed_backward_launches += int(packed)
    return dq, dk, dv


def session_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    adj: torch.Tensor,
    heads: int,
    dropout_p: float = 0.0,
    seed: int | torch.Tensor | None = None,
    packed: bool = False,
    first_session: int | None = None,
) -> torch.Tensor:
    """Masked multi-head attention; destinations with no in-edges output zeros.

    q/k/v: [B, N, heads*d] float32; adj: [B, N, N] bool or uint8
    (adj[b, dst, src]), or with `packed` the bit-packed rows [B, N,
    ceil(N / 8)] uint8 (source j is bit 7 - j % 8 of byte j // 8).
    `dropout_p` > 0 applies attention dropout keyed by the 64-bit `seed`, an
    int or a 0-dim int64 tensor on q's device holding its bits; 0 is the eval
    path. Session b draws the dropout bits of session ``first_session + b``
    (None: the active shard's first session, ``ops/shard.py``; 0 without one).
    Returns [B, N, heads*d] float32, differentiable with respect to q, k and v.
    """
    if first_session is None:
        first_session = shard.first_session()
    if dropout_p > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    if seed is None:
        seed = 0
    elif not isinstance(seed, torch.Tensor):
        seed &= 0xFFFFFFFFFFFFFFFF
    if q.device.type == "cpu":
        return session_attention_reference(q, k, v, adj, heads, dropout_p, seed, packed, first_session)
    return _launch(q, k, v, adj, heads, dropout_p, seed, None, packed, first_session)


def session_attention_variant(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    adj: torch.Tensor,
    heads: int,
    dropout_p: float,
    seed: int,
    variant: str,
    packed: bool = False,
) -> torch.Tensor:
    """``session_attention`` on CUDA tensors through the named forward kernel,
    ``"warp"`` (one warp per destination row) or ``"staged"`` (one block per
    session and head), whatever the batch. For measuring the crossover
    between the two; the port itself calls ``session_attention``."""
    if variant not in ("warp", "staged"):
        raise ValueError(f"variant must be 'warp' or 'staged', got {variant!r}")
    return _launch(q, k, v, adj, heads, dropout_p, seed, variant, packed, 0)


def session_attention_launch_floor(B: int, N: int, heads: int, head_dim: int) -> None:
    """Launch an empty kernel with the grid, block and shared memory that the
    ``"warp"`` forward takes at this shape, on the current CUDA stream: what a
    launch costs before any work. For measuring; the port never calls it."""
    err = _lib().session_attention_launch_floor(
        B, N, heads, head_dim, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "session_attention_launch_floor")


def _launch(q, k, v, adj, heads, dropout_p, seed, variant: str | None, packed: bool, first_session: int):
    """Check the arguments and launch; `variant` None lets the source choose."""
    if q.device.type != "cuda":
        raise ValueError(f"session_attention runs on cuda or cpu tensors, got {q.device}")
    B, N, HD = q.shape
    d = HD // heads if heads > 0 else 0
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name}: expected float32 {tuple(q.shape)} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if packed and (adj.shape != (B, N, (N + 7) // 8) or adj.dtype != torch.uint8):
        raise ValueError(f"packed adj: expected uint8 {(B, N, (N + 7) // 8)}, got {adj.dtype} {tuple(adj.shape)}")
    if not packed and (adj.shape != (B, N, N) or adj.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"adj: expected bool/uint8 {(B, N, N)}, got {adj.dtype} {tuple(adj.shape)}")
    if adj.device != q.device or not adj.is_contiguous():
        raise ValueError("adj must be contiguous on the same device as q")
    if heads < 1 or HD != heads * d or d % 4 or not 4 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim={HD}/{heads} must be a multiple of 4 in [4, {MAX_HEAD_DIM}]")
    if not 1 <= N <= MAX_NODES:
        raise ValueError(f"N={N} nodes; the kernel takes 1..{MAX_NODES}")
    keep_threshold(dropout_p)  # validates the rate before anything launches
    return _SessionAttention.apply(q, k, v, adj, heads, dropout_p, _seed_on(q.device, dropout_p, seed),
                                   variant, packed, first_session)


def _seed_on(device, dropout_p: float, seed) -> torch.Tensor | None:
    """The seed where the kernels read it: None without dropout, a 0-dim
    int64 tensor on `device` with dropout (``step_block.seed_on``)."""
    return None if dropout_p == 0.0 else step_block.seed_on(seed, device)


session_attention.launches = 0
session_attention.staged_launches = 0
session_attention.backward_launches = 0
session_attention.packed_launches = 0
session_attention.packed_backward_launches = 0
