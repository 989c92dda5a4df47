"""Lazy catch-up AdamW over the item-embedding table: O(touched rows) a step.

The eager sparse update (``ops/sparse_adamw.py``) sweeps the whole ``[V, D]``
table and both moments every step, because AdamW moves every row every step:
an untouched row (zero gradient) decays its moments (``mu *= b1``, ``nu *=
b2``), decays its weight by ``1 - lr*wd`` and keeps absorbing the momentum
tail ``-lr * mu_hat / (sqrt(nu_hat) + eps)``. All three are functions of the
row's values at its last touch and of the number of steps skipped, so the
lazy update applies them at the row's next touch, in closed form:

    w_m = a^m w_0 - lr * sum_{j=1..m} a^(m-j) u_j,      a = 1 - lr*wd
    u_j = (b1^j mu_0 / (1 - b1^(s0+j))) / (sqrt(b2^j nu_0 / (1 - b2^(s0+j))) + eps)

The terms shrink like (b1/sqrt(b2))^j, about 0.9^j; the series stops after
``TAIL_TERMS`` = 64 terms, which leaves about 1e-5 of absolute weight error at
lr 1e-3. Decay powers are taken in log space: ``1 - lr*wd`` is ``1 - 1e-8``
at the usual settings and rounds to 1 in float32. A step then gathers and
catches up the U touched rows, runs forward and backward on them, applies
AdamW at the step's count to those rows only and scatters them back with
``last_step = count``; ``materialize`` catches every row up before the table
is read outside training (evaluation, checkpoints).

The plain functions ``catch_up``, ``touched_update``, ``materialize_arrays``
and ``dense_reference_step`` are float32 and follow the JAX package's
expressions in the JAX package's order (``ops/lazy_adamw.py`` there). Three
wrappers launch the hand-written kernels of ``csrc/lazy_adamw.cu`` on CUDA
tensors and run the plain versions on CPU tensors; there is no other switch:

- ``gather_catch_up`` -> ``lazy_gather_catch_up``: the uid rows caught up to
  ``count - 1`` as float32 ``[U, D]`` buffers (zeros for sentinel slots).
- ``touched_update_scatter`` -> ``lazy_touched_update``: the AdamW step at
  ``count`` on those buffers, scattered into table, moments and ``last_step``
  in place; sentinel slots are dropped.
- ``materialize`` -> ``lazy_materialize``: every row caught up to ``count``,
  in place, ``last_step = count``.

The first two run inside the chained train step's CUDA graphs, so their
``count`` is the step's row of the step block (``ops/step_block.py``): the
kernels read the count, the bias denominators and the rounding seeds from
device memory. Given a Python int they build that row themselves.

Moments are float32 or bfloat16 (stochastic rounding keyed by ``(count,
buffer)`` and the counter ``row * D + column``, as ``ops/embedding_adamw.py``
stores them). Scalars that divide are tensors on the data's device, so a
division stays a division on the card too (PyTorch turns ``tensor / python
float`` into a multiplication by the reciprocal there).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from gat_recommendation_torch.ops import _build, step_block
from gat_recommendation_torch.ops.embedding_adamw import (
    bias_denominators,
    check_table_args,
    moment_seed,
    round_moment,
    stochastic_flags,
)

# Momentum-tail series length: b1^64 = 1.2e-3, so the dropped remainder is
# about 1e-2 of one update unit, about 1e-5 of absolute weight at lr 1e-3.
TAIL_TERMS = 64
MAX_TAIL_TERMS = 64  # kMaxTerms of csrc/lazy_adamw.cu
MATERIALIZE_CHUNK_ROWS = 1 << 16  # rows a step of the plain in-place materialize


def catch_up(w, mu, nu, last_step, m, *, lr, b1, b2, eps, weight_decay, tail_terms=TAIL_TERMS):
    """Apply m zero-gradient AdamW steps to rows last touched at `last_step`.

    w, mu, nu: float32 [U, D] row values as stored at step `last_step`;
    last_step, m: integer [U], m >= 0 the steps to apply (global steps
    last_step + 1 .. last_step + m). Returns (w_c, mu_c, nu_c), what dense
    AdamW would hold after step last_step + m, within the tail truncation.
    """
    if not (0.0 < b1 < 1.0 and 0.0 < b2 < 1.0):
        raise ValueError("the closed forms need 0 < b1, b2 < 1")
    mf = m.float()[:, None]
    sf = last_step.float()[:, None]
    ln_b1, ln_b2 = math.log(b1), math.log(b2)
    a_log = math.log1p(-lr * weight_decay)
    sqnu = nu.sqrt()
    acc = torch.zeros_like(w)
    for j in range(1, tail_terms + 1):
        s = sf + j  # global index of the j-th skipped step
        bc1 = 1.0 - torch.exp(s * ln_b1)  # underflows to exactly 1 for old rows
        bc2 = 1.0 - torch.exp(s * ln_b2)
        c1 = torch.full_like(bc1, b1**j) / bc1
        c2 = (torch.full_like(bc2, b2**j) / bc2).sqrt()
        u = c1 * mu / (c2 * sqnu + eps)
        # a^(m-j) gate: rows with m < j take nothing of this term.
        fac = torch.where(mf >= j, torch.exp((mf - j).clamp_min(0.0) * a_log), 0.0)
        acc = acc + fac * u
    w_c = torch.exp(mf * a_log) * w - lr * acc
    mu_c = torch.exp(mf * ln_b1) * mu
    nu_c = torch.exp(mf * ln_b2) * nu
    return w_c, mu_c, nu_c


def touched_update(w_c, mu_c, nu_c, g, count: int, *, lr, b1, b2, eps, weight_decay):
    """One AdamW step at global step `count` on caught-up rows: bias
    correction by `count` (divided, not multiplied by a reciprocal), decoupled
    weight decay on the pre-update weight. Returns (w, mu, nu), float32."""
    bc1, bc2 = bias_denominators(count, b1, b2)
    mu = b1 * mu_c + (1.0 - b1) * g
    nu = b2 * nu_c + (1.0 - b2) * (g * g)
    mu_hat = mu / mu.new_full((1,), bc1)
    nu_hat = nu / nu.new_full((1,), bc2)
    w = w_c - lr * (mu_hat / (nu_hat.sqrt() + eps) + weight_decay * w_c)
    return w, mu, nu


def materialize_arrays(table, mu, nu, last_step, count: int, *, lr, b1, b2, eps, weight_decay,
                       tail_terms=TAIL_TERMS):
    """Catch every row up to step `count` with no new gradient. Returns
    (table, mu, nu, last_step) with float32 moments and last_step == count
    everywhere. Idempotent (m = 0 keeps a row's bits)."""
    m = (count - last_step).clamp_min(0)
    w, mu_c, nu_c = catch_up(table, mu.float(), nu.float(), last_step, m, lr=lr, b1=b1, b2=b2,
                             eps=eps, weight_decay=weight_decay, tail_terms=tail_terms)
    return w, mu_c, nu_c, torch.full_like(last_step, count)


def dense_reference_step(w, mu, nu, g, count: int, *, lr, b1, b2, eps, weight_decay):
    """Plain dense AdamW over the whole array, the oracle the lazy path is
    tested against (the same arithmetic as ``touched_update``)."""
    return touched_update(w, mu, nu, g, count, lr=lr, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay)


# ---------------------------------------------------------------------------
# Plain in-place versions of the three kernels (what the wrappers run on CPU
# tensors, and what chip_smoke.py holds the kernels against on the card)
# ---------------------------------------------------------------------------


def _valid_slots(uid: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(valid [U] bool, row index [U] long with the invalid slots on row 0)."""
    valid = (uid >= 0) & (uid < rows)
    return valid, torch.where(valid, uid, 0).long()


def gather_catch_up_reference(table, mu, nu, last_step, uid, count: int, *, lr, b1=0.9, b2=0.999,
                              eps=1e-8, weight_decay=0.0, tail_terms=TAIL_TERMS):
    """Plain version of ``gather_catch_up``."""
    valid, idx = _valid_slots(uid, table.shape[0])
    ls = last_step[idx]
    m = (count - 1 - ls).clamp_min(0)
    out = catch_up(table[idx], mu[idx].float(), nu[idx].float(), ls, m, lr=lr, b1=b1, b2=b2,
                   eps=eps, weight_decay=weight_decay, tail_terms=tail_terms)
    return tuple(torch.where(valid[:, None], t, 0.0) for t in out)


def touched_update_scatter_reference(table, mu, nu, last_step, uid, w_c, mu_c, nu_c, summed,
                                     count: int, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                                     weight_decay=0.0, stochastic_rounding=False):
    """Plain version of ``touched_update_scatter``: updates table, mu, nu and
    last_step in place and returns them."""
    sr_mu, sr_nu = stochastic_flags(mu, nu, stochastic_rounding)
    w, m, n = touched_update(w_c, mu_c, nu_c, summed, count, lr=lr, b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay)
    rows = table.shape[0]
    valid, idx = _valid_slots(uid, rows)
    # Sentinel slots go to a spare row that is cut off again: no shape depends
    # on the data, so nothing waits for the device. uid is unique, so every
    # real row is written once.
    slot = torch.where(valid, idx, rows)
    values = (
        (table, w),
        (mu, round_moment(m, mu.dtype, sr_mu, moment_seed(count, 0), idx)),
        (nu, round_moment(n, nu.dtype, sr_nu, moment_seed(count, 1), idx)),
        (last_step, torch.full_like(uid, count)),
    )
    for dest, value in values:
        spare = dest.new_zeros((1, *dest.shape[1:]))
        dest.copy_(torch.cat([dest, spare]).index_copy_(0, slot, value)[:rows])
    return table, mu, nu, last_step


def materialize_reference(table, mu, nu, last_step, count: int, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                          weight_decay=0.0, tail_terms=TAIL_TERMS, stochastic_rounding=False,
                          chunk_rows=MATERIALIZE_CHUNK_ROWS):
    """Plain version of ``materialize``, in row chunks (the series holds a
    few float32 temporaries of the chunk's size); updates in place."""
    sr_mu, sr_nu = stochastic_flags(mu, nu, stochastic_rounding)
    for lo in range(0, table.shape[0], chunk_rows):
        hi = min(lo + chunk_rows, table.shape[0])
        w, m, n, last = materialize_arrays(
            table[lo:hi], mu[lo:hi], nu[lo:hi], last_step[lo:hi], count, lr=lr, b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay, tail_terms=tail_terms)
        rows = torch.arange(lo, hi, device=table.device)
        table[lo:hi] = w
        mu[lo:hi] = round_moment(m, mu.dtype, sr_mu, moment_seed(count, 0), rows)
        nu[lo:hi] = round_moment(n, nu.dtype, sr_nu, moment_seed(count, 1), rows)
        last_step[lo:hi] = last
    return table, mu, nu, last_step


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

_F, _I, _LL, _ULL, _P = (
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_void_p,
)


def lazy_lib() -> ctypes.CDLL:
    """The library of csrc/lazy_adamw.cu with its three entry points typed."""
    lib = _build.load("lazy_adamw")
    lib.lazy_gather_catch_up.argtypes = [_P] * 9 + [_I, _LL] + [_I] * 4 + [_F] * 5 + [_P] * 3
    lib.lazy_touched_update.argtypes = [_P] * 10 + [_I, _LL] + [_I] * 5 + [_F] * 7 + [_P]
    lib.lazy_materialize.argtypes = (
        [_P] * 4 + [_LL] + [_I] * 5 + [_ULL] * 2 + [_I] * 2 + [_F] * 5 + [_P] * 3
    )
    for fn in (lib.lazy_gather_catch_up, lib.lazy_touched_update, lib.lazy_materialize):
        fn.restype = _I
    return lib


def _check_table(name: str, table, mu, nu, last_step) -> None:
    check_table_args(name, table, mu, nu)
    if table.shape[0] >= 2**31:
        raise ValueError(f"{name}: at most 2^31 - 1 rows")
    if last_step.shape != table.shape[:1] or last_step.dtype != torch.int32 or last_step.device != table.device:
        raise ValueError(f"{name}: last_step must be int32 [{table.shape[0]}] on {table.device}")
    _check_contiguous(name, last_step=last_step)


def _check_rows(name: str, table, uid, **rows) -> None:
    if uid.dim() != 1 or uid.dtype != torch.int32 or uid.device != table.device:
        raise ValueError(f"{name}: uid must be int32 [U] on {table.device}")
    want = (uid.shape[0], table.shape[1])
    for label, t in rows.items():
        if t.shape != want or t.dtype != torch.float32 or t.device != table.device:
            raise ValueError(f"{name}: {label} must be float32 {want} on {table.device}")
    _check_contiguous(name, uid=uid, **rows)


def _check_contiguous(name: str, **tensors) -> None:
    for label, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")


def _check_terms(name: str, tail_terms: int) -> None:
    if not 1 <= tail_terms <= MAX_TAIL_TERMS:
        raise ValueError(f"{name}: tail_terms must lie in 1..{MAX_TAIL_TERMS}, got {tail_terms}")


def _check_eps(name: str, eps: float) -> None:
    """The kernels' series multiplies by the reciprocal of c2 * sqrt(nu) + eps,
    which has no special cases (1/0 would be inf where the plain version's
    0/0 is nan and x/0 inf): it needs eps > 0."""
    if not eps > 0.0:
        raise ValueError(f"{name}: the kernel needs eps > 0, got {eps}")


def _series_args(lr, b1, b2, weight_decay, tail_terms):
    """The catch-up's scalars for the kernel, and the float32 b^j arrays (to
    be kept alive until the call returns)."""
    powers = [np.array([b**j for j in range(1, tail_terms + 1)], np.float32) for b in (b1, b2)]
    scalars = (math.log(b1), math.log(b2), math.log1p(-lr * weight_decay))
    return scalars, powers


def _device(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")
    return t.device.type == "cuda"


def gather_catch_up(table, mu, nu, last_step, uid, count: int | torch.Tensor, *, lr, b1=0.9,
                    b2=0.999, eps=1e-8, weight_decay=0.0, tail_terms=TAIL_TERMS):
    """The uid rows caught up to step ``count - 1`` (``count``: the step number
    after this update, an int or the step's row of the step block on the
    table's device): float32 (w_c, mu_c, nu_c), each [U, D], zeros for slots
    outside the table.

    table: float32 [rows, D]; mu, nu: float32 or bfloat16 [rows, D];
    last_step: int32 [rows]; uid: int32 [U] unique row ids, sentinel-padded.
    """
    _check_terms("gather_catch_up", tail_terms)
    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, tail_terms=tail_terms)
    if not _device("gather_catch_up", table):
        return gather_catch_up_reference(table, mu, nu, last_step, uid, step_block.count_of(count), **hp)
    _check_table("gather_catch_up", table, mu, nu, last_step)
    _check_rows("gather_catch_up", table, uid)
    _check_eps("gather_catch_up", eps)
    row = step_block.row_on(count, b1=b1, b2=b2, device=table.device)
    out = [torch.empty(uid.shape[0], table.shape[1], device=table.device) for _ in range(3)]
    (ln_b1, ln_b2, a_log), (p1, p2) = _series_args(lr, b1, b2, weight_decay, tail_terms)
    with torch.cuda.device(table.device):
        err = lazy_lib().lazy_gather_catch_up(
            table.data_ptr(), mu.data_ptr(), nu.data_ptr(), last_step.data_ptr(), uid.data_ptr(),
            *(t.data_ptr() for t in out), row.data_ptr(), uid.shape[0], table.shape[0],
            table.shape[1], mu.dtype == torch.bfloat16, nu.dtype == torch.bfloat16, tail_terms,
            lr, eps, ln_b1, ln_b2, a_log, p1.ctypes.data, p2.ctypes.data,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "lazy_gather_catch_up")
    gather_catch_up.launches += 1
    return tuple(out)


def touched_update_scatter(table, mu, nu, last_step, uid, w_c, mu_c, nu_c, summed,
                           count: int | torch.Tensor, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=0.0, stochastic_rounding=False):
    """AdamW at step `count` (an int or the step's row of the step block) on
    the caught-up rows (w_c, mu_c, nu_c from ``gather_catch_up`` on the same
    uid) with their summed gradient [U, D], scattered into the uid rows of
    table, mu and nu, and ``last_step[uid] = count``; sentinel slots are
    dropped. In place; returns the four."""
    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if not _device("touched_update_scatter", table):
        return touched_update_scatter_reference(
            table, mu, nu, last_step, uid, w_c, mu_c, nu_c, summed, step_block.count_of(count),
            stochastic_rounding=stochastic_rounding, **hp)
    _check_table("touched_update_scatter", table, mu, nu, last_step)
    _check_rows("touched_update_scatter", table, uid, w_c=w_c, mu_c=mu_c, nu_c=nu_c, summed=summed)
    sr_mu, sr_nu = stochastic_flags(mu, nu, stochastic_rounding)
    row = step_block.row_on(count, b1=b1, b2=b2, device=table.device)
    with torch.cuda.device(table.device):
        err = lazy_lib().lazy_touched_update(
            table.data_ptr(), mu.data_ptr(), nu.data_ptr(), last_step.data_ptr(), uid.data_ptr(),
            w_c.data_ptr(), mu_c.data_ptr(), nu_c.data_ptr(), summed.data_ptr(), row.data_ptr(),
            uid.shape[0], table.shape[0], table.shape[1],
            mu.dtype == torch.bfloat16, nu.dtype == torch.bfloat16, sr_mu, sr_nu,
            lr, b1, b2, eps, weight_decay, 1.0 - b1, 1.0 - b2,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "lazy_touched_update")
    touched_update_scatter.launches += 1
    return table, mu, nu, last_step


def materialize(table, mu, nu, last_step, count: int, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, tail_terms=TAIL_TERMS, stochastic_rounding=False):
    """Every row caught up to step `count` (the optimizer's current count) with
    no new gradient, ``last_step = count``. In place; returns the four.
    Idempotent: a row already at `count` keeps its bits."""
    _check_terms("materialize", tail_terms)
    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, tail_terms=tail_terms)
    if not _device("materialize", table):
        return materialize_reference(table, mu, nu, last_step, count,
                                     stochastic_rounding=stochastic_rounding, **hp)
    _check_table("materialize", table, mu, nu, last_step)
    _check_eps("materialize", eps)
    sr_mu, sr_nu = stochastic_flags(mu, nu, stochastic_rounding)
    (ln_b1, ln_b2, a_log), (p1, p2) = _series_args(lr, b1, b2, weight_decay, tail_terms)
    with torch.cuda.device(table.device):
        err = lazy_lib().lazy_materialize(
            table.data_ptr(), mu.data_ptr(), nu.data_ptr(), last_step.data_ptr(),
            table.shape[0], table.shape[1], mu.dtype == torch.bfloat16, nu.dtype == torch.bfloat16,
            sr_mu, sr_nu, moment_seed(count, 0), moment_seed(count, 1), count, tail_terms,
            lr, eps, ln_b1, ln_b2, a_log, p1.ctypes.data, p2.ctypes.data,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "lazy_materialize")
    materialize.launches += 1
    return table, mu, nu, last_step


gather_catch_up.launches = 0
touched_update_scatter.launches = 0
materialize.launches = 0
