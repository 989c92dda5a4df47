"""Counter-based random bits and stochastic rounding f32 -> bf16.

Why stochastic rounding: bf16 moment storage halves the optimizer's memory
traffic, but under round-to-nearest the second moment's per-step increment
((1-b2) = 0.1 % of its running value) lies below a bf16 ulp (2^-8 relative),
rounds to zero and the moment stalls. Stochastic rounding makes the stored
value an unbiased estimator, so tiny increments survive in expectation.

Mechanics: bf16 is the top 16 bits of the f32 pattern. Add a uniform 16-bit
integer to the f32 bits and truncate the low 16: the carry promotes to the
next representable bf16 with probability equal to the discarded fraction.
Exactly representable values (low bits zero) never change.

The random bits are a pure function of a counter, so a CUDA kernel and the
plain PyTorch version draw the SAME bits and agree bit for bit:

    counter_hash(seed, idx) = mix32(mix32(lo(idx) ^ lo(seed)) ^ hi(seed) ^ hi(idx))
    mix32(x): x ^= x >> 15; x *= 0x2c1b3c6d; x ^= x >> 12; x *= 0x297a2d39; x ^= x >> 15

(all modulo 2^32; lo/hi are the 32-bit halves of a 64-bit value). ``mix32``
is a two-round multiply-xorshift integer hash; both multipliers are below
2^31, so the products of 32-bit values fit a signed 64-bit integer and the
plain version needs no wrapping arithmetic. ``csrc/counter_hash.cuh`` is the
same function in CUDA. Seeds are 64-bit values from ``mix_seed`` (SplitMix64
on the host), so consecutive steps do not get neighbouring seeds. Dropout
(attention weights in ``csrc/session_attention.cu``, nodes in
``csrc/node_dropout.cu``) keeps an element when the top 24 of its 32 bits lie
below ``keep_threshold`` and scales it by ``keep_scale``. The JAX package
draws its bits from ``jax.random``, so the two packages agree in
distribution only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_KEEP_ALL = 1 << 24


def mix_seed(*values: int) -> int:
    """A 64-bit seed from a tuple of integers (host side, SplitMix64 chained).

    Used for every derived seed of the port: the per-step seed from
    ``(seed, epoch, step)``, the per-layer dropout seeds, and the per-buffer
    stochastic-rounding seeds from ``(count, buffer)``.
    """
    state = 0x9E3779B97F4A7C15
    for v in values:
        state = (state + (int(v) & _M64) + 0x9E3779B97F4A7C15) & _M64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        state = z ^ (z >> 31)
    return state


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit mixer on int64 tensors that hold values in [0, 2^32)."""
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    x = x ^ (x >> 12)
    x = (x * 0x297A2D39) & _M32
    return x ^ (x >> 15)


def counter_hash(seed: int | torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """32 random bits per counter value. `seed`: a 64-bit int, or a 0-dim
    int64 tensor holding its bits (a field of the step block read on the
    device, so nothing waits for the host); `idx`: int64 tensor of
    non-negative counters. Returns int64 values in [0, 2^32)."""
    if isinstance(seed, torch.Tensor):
        lo, hi = seed & _M32, (seed >> 32) & _M32  # the halves of the 64-bit pattern
    else:
        seed &= _M64
        lo, hi = seed & _M32, seed >> 32
    inner = _mix32((idx & _M32) ^ lo)
    return _mix32(inner ^ hi ^ (idx >> 32))


def keep_threshold(rate: float) -> int:
    """The 24-bit integer below which ``counter_hash(...) >> 8`` keeps an
    element under dropout at `rate`."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {rate}")
    return _KEEP_ALL if rate == 0.0 else round((1.0 - rate) * _KEEP_ALL)


def keep_scale(rate: float) -> float:
    """The scale of a kept element under dropout at `rate`: 1 / (1 - rate)
    rounded to float32, so that a float32 product with it is the same in the
    plain version and in a kernel."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def keep_mask(shape, rate: float, seed: int | torch.Tensor, device) -> torch.Tensor:
    """The bool keep mask of dropout at `rate` over `shape`: element i is kept
    when ``counter_hash(seed, i) >> 8`` (i its linear index) lies below
    ``keep_threshold(rate)``."""
    idx = torch.arange(math.prod(shape), device=device).view(shape)
    return (counter_hash(seed, idx) >> 8) < keep_threshold(rate)


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Round float32 `x` to bfloat16 stochastically (unbiased) with the low 16
    bits of the integer tensor `bits` (same shape) as the random numbers."""
    if x.dtype != torch.float32:
        raise ValueError(f"stochastic_round_bf16 takes float32, got {x.dtype}")
    pattern = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    rounded = (pattern + (bits.to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    # Back to a signed 32-bit pattern; the low 16 bits are zero, so the cast
    # to bfloat16 is exact.
    rounded = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded)
    return rounded.to(torch.int32).view(torch.float32).to(torch.bfloat16)
