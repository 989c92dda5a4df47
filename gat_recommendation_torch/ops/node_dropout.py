"""Node dropout: inverted dropout of the node features after each layer.

``node_dropout`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel of ``csrc/node_dropout.cu`` or raises; on a CPU tensor it
runs the plain version ``ops/masked.py::dropout``. Both keep element i when
``counter_hash(seed, offset + i) >> 8`` lies below ``keep_threshold(rate)``
and scale it by ``keep_scale(rate)`` (``ops/rounding.py``), so they agree bit
for bit. `offset` is 0 on one GPU; under a mesh a data rank holds sessions
``[b0, b0 + b)`` of the global batch and passes ``b0`` times the elements of
a session (``ops/masked.py::session_offset``, the default), so that it draws
at its rows the bits the whole batch draws on one GPU. It goes by value, as
the kernel's shape does.
The kernel reads the seed from device memory: a 0-dim int64 tensor on the
card (a layer's field of the step block, ``ops/step_block.py``, so that a
CUDA graph of the train step replays every step with its own mask), or, for
a Python int, a one-element tensor the wrapper copies there.

On the card the function is a ``torch.autograd.Function`` that saves nothing:
its gradient is the same mask and scale applied to the output gradient, the
same kernel launched again. ``node_dropout.launches`` counts every launch,
forward and backward.
"""

from __future__ import annotations

import ctypes

import torch

from gat_recommendation_torch.ops import _build, step_block
from gat_recommendation_torch.ops.masked import dropout as node_dropout_reference
from gat_recommendation_torch.ops.masked import session_offset
from gat_recommendation_torch.ops.rounding import keep_scale, keep_threshold


def _lib() -> ctypes.CDLL:
    lib = _build.load("node_dropout")
    lib.node_dropout.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
    lib.node_dropout.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, rate: float, seed: torch.Tensor, offset: int) -> torch.Tensor:
    x = x.contiguous()
    if x.dtype != torch.float32 or x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError(f"node_dropout: float32 with a multiple of 4 elements, 16-byte aligned; "
                         f"got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().node_dropout(x.data_ptr(), out.data_ptr(), x.numel(), seed.data_ptr(), offset,
                                  keep_threshold(rate), keep_scale(rate),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "node_dropout")
    node_dropout.launches += 1
    return out


class _NodeDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate: float, seed: torch.Tensor, offset: int):
        ctx.args = (rate, seed, offset)
        return _launch(x, rate, seed, offset)

    @staticmethod
    def backward(ctx, grad_out):
        return _launch(grad_out, *ctx.args), None, None, None


def node_dropout(x: torch.Tensor, rate: float, seed: int | torch.Tensor, offset: int | None = None) -> torch.Tensor:
    """Train-mode inverted dropout of `x` at `rate` keyed by the 64-bit `seed`
    (an int, or a 0-dim int64 tensor on x's device holding its bits) and the
    counter `offset` of x[0] (None: the active shard's,
    ``ops/masked.py::session_offset``); `x` itself at rate 0. Differentiable
    with respect to `x`."""
    if rate <= 0.0:
        return x
    offset = session_offset(x) if offset is None else offset
    if x.device.type == "cpu":
        return node_dropout_reference(x, rate, True, seed, offset)
    if x.device.type != "cuda":
        raise ValueError(f"node_dropout runs on cuda or cpu tensors, got {x.device}")
    keep_threshold(rate)  # validates the rate before anything launches
    return _NodeDropout.apply(x, rate, step_block.seed_on(seed, x.device), offset)


node_dropout.launches = 0
