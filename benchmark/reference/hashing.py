"""Seeds and counter-based random bits, frozen copies of the arithmetic the
program states for them (so the reference draws the same bits from the same
seed without importing the program):

- ``mix_seed``: SplitMix64 chained over a tuple of integers; the step seed is
  ``mix_seed(trainer_seed, epoch, step)`` and a layer's dropout seed
  ``mix_seed(step_seed, layer, j)``.
- ``counter_hash(seed, idx)``: ``mix32(mix32(lo(idx) ^ lo(seed)) ^ hi(seed) ^ hi(idx))``
  with ``mix32(x) = x ^= x >> 15; x *= 0x2c1b3c6d; x ^= x >> 12; x *= 0x297a2d39; x ^= x >> 15``.
  Dropout keeps element i when ``counter_hash(seed, i) >> 8`` lies below
  ``round((1 - rate) * 2**24)``.
- the batch engine's negatives: a SplitMix64 stream per slot starting at
  ``batch_seed ^ 0x9e3779b97f4a7c15 * (slot + 1)``, ``batch_seed = (seed << 20) + batch_index``,
  candidates ``1 + z % (num_items - 1)`` rejected while in the session.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
GOLDEN = 0x9E3779B97F4A7C15


def mix_seed(*values: int) -> int:
    state = GOLDEN
    for v in values:
        state = (state + (int(v) & M64) + GOLDEN) & M64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
        state = z ^ (z >> 31)
    return state


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & M32
    x = x ^ (x >> 12)
    x = (x * 0x297A2D39) & M32
    return x ^ (x >> 15)


def counter_hash(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64 in [0, 2**32)) per non-negative int64 counter."""
    seed &= M64
    inner = _mix32((idx & M32) ^ (seed & M32))
    return _mix32(inner ^ (seed >> 32) ^ (idx >> 32))


def keep_mask(shape, rate: float, seed: int, device) -> torch.Tensor:
    """Dropout's keep mask over `shape` (element i by its linear index)."""
    threshold = 1 << 24 if rate == 0.0 else round((1.0 - rate) * (1 << 24))
    idx = torch.arange(math.prod(shape), device=device).view(shape)
    return (counter_hash(seed, idx) >> 8) < threshold


def keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to float32."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def batch_seed(seed: int, batch_index: int) -> int:
    return ((int(seed) << 20) + int(batch_index)) & M64


def negatives(bseed: int, slot: int, session_items, num_items: int, k: int) -> list[int]:
    """The k negatives of one batch slot: rejection sampling from [1, num_items)
    outside the session's items, at most 128 * k attempts, then any items."""
    if num_items <= 1:
        return [0] * k
    inside = set(int(x) for x in session_items)
    state = (bseed ^ ((GOLDEN * (slot + 1)) & M64)) & M64
    out: list[int] = []

    def draw() -> int:
        nonlocal state
        state = (state + GOLDEN) & M64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
        return 1 + (z ^ (z >> 31)) % (num_items - 1)

    attempts = 0
    while len(out) < k and attempts < 128 * k:
        attempts += 1
        cand = draw()
        if cand not in inside:
            out.append(cand)
    while len(out) < k:
        out.append(draw())
    return out
