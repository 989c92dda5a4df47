"""Dense AdamW over the item-embedding table, one pass, in place.

For the whole ``[V, D]`` table from a dense gradient: ``mu = b1*mu +
(1-b1)*g``, ``nu = b2*nu + (1-b2)*g*g``, then the shared tail ``w -= lr *
(mu*ibc1 / (sqrt(nu*ibc2) + eps) + wd*w)`` (AdamW with decoupled weight
decay, eps outside the square root, bias corrections ``ibc = 1/(1-b^count)``;
``count`` is the step number AFTER this update, 1 on the first call). Moments
are stored as float32, or as bfloat16 rounded to nearest, or as bfloat16 with
stochastic rounding (``ops/rounding.py``); the arithmetic is float32 always.

``embedding_adamw`` is the wrapper: on CUDA tensors it launches the
hand-written kernel ``csrc/embedding_adamw.cu::embedding_adamw`` (which
replaces the JAX package's Pallas kernel ``ops/pallas/embedding_adamw.py::
fused_embedding_adamw``) or raises; on CPU tensors it runs the plain version
``embedding_adamw_reference``. Both update ``w``, ``mu`` and ``nu`` IN PLACE
(the Pallas kernel returns fresh arrays) and return them.

The bias corrections are computed on the host in float32, as the JAX package
computes them: near count = 1..10, ``1 - 0.999^count`` loses five digits in
float32, so a double-precision value would differ from the JAX package's by
about 2e-5 relative. ``count`` is a Python int; nothing is read back from
the device.

The pieces shared with the sparse update (``ops/sparse_adamw.py``) live here:
the bias corrections, the tail, the moment store and the kernel's argument
checks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gat_recommendation_torch.ops import _build
from gat_recommendation_torch.ops.rounding import counter_hash, mix_seed, stochastic_round_bf16

MOMENT_DTYPES = (torch.float32, torch.bfloat16)


def bias_corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """``(1/(1-b1^count), 1/(1-b2^count))`` in float32 arithmetic."""
    if count < 1:
        raise ValueError(f"count is the step number after the update (>= 1), got {count}")
    one, c = np.float32(1.0), np.float32(count)
    return (
        float(one / (one - np.float32(b1) ** c)),
        float(one / (one - np.float32(b2) ** c)),
    )


def moment_seed(count: int, buffer: int) -> int:
    """The stochastic-rounding seed of one moment buffer (0 = mu, 1 = nu) at one step."""
    return mix_seed(0x5352, count, buffer)


def stochastic_flags(mu: torch.Tensor, nu: torch.Tensor, stochastic_rounding: bool) -> tuple[bool, bool]:
    """Stochastic rounding applies per buffer: only a bfloat16 moment rounds stochastically."""
    sr_mu = stochastic_rounding and mu.dtype == torch.bfloat16
    sr_nu = stochastic_rounding and nu.dtype == torch.bfloat16
    if stochastic_rounding and not (sr_mu or sr_nu):
        raise ValueError("stochastic rounding requested but neither moment is bfloat16")
    return sr_mu, sr_nu


def store_moment(
    dest: torch.Tensor, value: torch.Tensor, stochastic: bool, seed: int, row_offset: int
) -> None:
    """Write float32 `value` into the moment buffer `dest` (float32 or bfloat16).
    The random bits of element (row, col) come from the counter
    ``(row_offset + row) * D + col``."""
    if stochastic:
        rows, dim = value.shape
        idx = (torch.arange(rows, device=value.device) + row_offset)[:, None] * dim
        idx = idx + torch.arange(dim, device=value.device)
        value = stochastic_round_bf16(value, counter_hash(seed, idx))
    dest.copy_(value)


def adamw_tail(w, mu, nu, ibc1: float, ibc2: float, lr: float, eps: float, weight_decay: float):
    """The new weights from float32 moments that are already decayed and updated."""
    return w - lr * ((mu * ibc1) / ((nu * ibc2).sqrt() + eps) + weight_decay * w)


def embedding_adamw_reference(
    w: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    grad: torch.Tensor,
    count: int,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    row_offset: int = 0,
    stochastic_rounding: bool = False,
):
    """Plain PyTorch version; updates w, mu, nu in place and returns them."""
    sr_mu, sr_nu = stochastic_flags(mu, nu, stochastic_rounding)
    ibc1, ibc2 = bias_corrections(count, b1, b2)
    m = b1 * mu.float() + (1.0 - b1) * grad
    n = b2 * nu.float() + (1.0 - b2) * (grad * grad)
    w.copy_(adamw_tail(w, m, n, ibc1, ibc2, lr, eps, weight_decay))
    store_moment(mu, m, sr_mu, moment_seed(count, 0), row_offset)
    store_moment(nu, n, sr_nu, moment_seed(count, 1), row_offset)
    return w, mu, nu


def check_table_args(name: str, w, mu, nu) -> None:
    """What both AdamW kernels take: a float32 [rows, D] table with D % 4 == 0
    and float32 or bfloat16 moments of its shape, contiguous, on one device."""
    if w.dim() != 2 or w.dtype != torch.float32 or w.shape[1] % 4:
        raise ValueError(f"{name}: the table must be float32 [rows, D] with D % 4 == 0")
    for label, t in (("mu", mu), ("nu", nu)):
        if t.shape != w.shape or t.dtype not in MOMENT_DTYPES or t.device != w.device:
            raise ValueError(f"{name}: {label} must be float32 or bfloat16 {tuple(w.shape)} on {w.device}")
    for label, t in (("table", w), ("mu", mu), ("nu", nu)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")
    if w.shape[0] * (w.shape[1] // 4) > 256 * (2**31 - 1):
        raise ValueError(f"{name}: table of {tuple(w.shape)} exceeds the kernel's grid")


_F, _I, _LL, _ULL, _P = (
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_void_p,
)


def adamw_lib() -> ctypes.CDLL:
    """The library of csrc/embedding_adamw.cu with both entry points typed."""
    lib = _build.load("embedding_adamw")
    lib.sparse_adamw.argtypes = (
        [_P] * 5 + [_I, _LL, _I, _LL] + [_I] * 4 + [_ULL] * 2 + [_F] * 9 + [_P]
    )
    lib.sparse_adamw.restype = _I
    lib.embedding_adamw.argtypes = (
        [_P] * 4 + [_LL, _I, _LL] + [_I] * 4 + [_ULL] * 2 + [_F] * 9 + [_P]
    )
    lib.embedding_adamw.restype = _I
    return lib


def embedding_adamw(
    w: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    grad: torch.Tensor,
    count: int,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    row_offset: int = 0,
    stochastic_rounding: bool = False,
):
    """Dense AdamW over the [V, D] table in one pass; w, mu, nu updated in place.

    w, grad: float32 [V, D]; mu, nu: float32 or bfloat16 [V, D]; `count`: the
    step number after this update. `row_offset`: the first global row of `w`
    when it is a row shard (it only keys the stochastic-rounding bits).
    """
    if w.device.type == "cpu":
        return embedding_adamw_reference(
            w, mu, nu, grad, count, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            row_offset=row_offset, stochastic_rounding=stochastic_rounding,
        )
    if w.device.type != "cuda":
        raise ValueError(f"embedding_adamw runs on cuda or cpu tensors, got {w.device}")
    check_table_args("embedding_adamw", w, mu, nu)
    if grad.shape != w.shape or grad.dtype != torch.float32 or grad.device != w.device:
        raise ValueError(f"embedding_adamw: grad must be float32 {tuple(w.shape)} on {w.device}")
    if not grad.is_contiguous() or grad.data_ptr() % 16:
        raise ValueError("embedding_adamw: grad must be contiguous and 16-byte aligned")
    sr_mu, sr_nu = stochastic_flags(mu, nu, stochastic_rounding)
    ibc1, ibc2 = bias_corrections(count, b1, b2)
    with torch.cuda.device(w.device):
        err = adamw_lib().embedding_adamw(
            w.data_ptr(), mu.data_ptr(), nu.data_ptr(), grad.data_ptr(),
            w.shape[0], w.shape[1], row_offset,
            mu.dtype == torch.bfloat16, nu.dtype == torch.bfloat16, sr_mu, sr_nu,
            moment_seed(count, 0), moment_seed(count, 1),
            lr, b1, b2, eps, weight_decay, 1.0 - b1, 1.0 - b2, ibc1, ibc2,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "embedding_adamw")
    embedding_adamw.launches += 1
    return w, mu, nu


embedding_adamw.launches = 0
