"""The per-step parameter block: what changes from one train step to the
next, in device memory.

A CUDA graph freezes every by-value kernel argument at the step it was
captured in, so whatever moves from step to step reaches the kernels through
device memory instead: one row of int64 fields per step, C rows for a chain
group, copied to the card once per group. The host fills the rows with the
functions the by-value arguments came from, so a kernel reads the same bits.
Fields (``csrc/step_block.cuh`` holds the same layout):

    COUNT             the step number after this update (``state["count"] + 1``)
    BC1, BC2          1 - b^count, float32 bit patterns (``bias_denominators``)
    IBC1, IBC2        1 / (1 - b^count), float32 bit patterns (``bias_corrections``)
    SEED_MU, SEED_NU  the moments' stochastic-rounding seeds (``moment_seed``)
    then per layer    the model's ``seeds_per_layer`` dropout seeds
                      ``mix_seed(step_seed, layer, j)``, j = 0 .. seeds_per_layer - 1

A model states how many seeds a layer takes and what each keys: the Graph
Transformer and GAT 2 (j = 0 the attention dropout, j = 1 the node dropout),
the Graph Transformer with its FFN 4 (j = 2 and 3 the FFN's two dropouts),
GraphSAGE 1 (its node dropout). So the optimized Graph Transformer's rows are
[C, 11], as they were before the other models took rows.

Seeds are 64-bit values stored as their two's-complement int64. The
optimizer's ``state["count"]`` stays a Python int on the host: a group of C
steps advances it by C, and nothing is read back. The AdamW kernels read a
row through a pointer, the dropout kernels a seed field (``seed_on``).

The bias corrections are computed on the host in float32, as the JAX package
computes them: near count = 1..10, ``1 - 0.999^count`` loses five digits in
float32, so a double-precision value would differ from the JAX package's by
about 2e-5 relative.
"""

from __future__ import annotations

import numpy as np
import torch

from gat_recommendation_torch.ops.rounding import mix_seed

COUNT, BC1, BC2, IBC1, IBC2, SEED_MU, SEED_NU = range(7)
LAYER_FIELDS = 7


def bias_denominators(count: int, b1: float, b2: float) -> tuple[float, float]:
    """``(1-b1^count, 1-b2^count)`` in float32 arithmetic."""
    if count < 1:
        raise ValueError(f"count is the step number after the update (>= 1), got {count}")
    one, c = np.float32(1.0), np.float32(count)
    return float(one - np.float32(b1) ** c), float(one - np.float32(b2) ** c)


def bias_corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """``(1/(1-b1^count), 1/(1-b2^count))`` in float32 arithmetic."""
    one = np.float32(1.0)
    return tuple(float(one / np.float32(d)) for d in bias_denominators(count, b1, b2))


def moment_seed(count: int, buffer: int) -> int:
    """The stochastic-rounding seed of one moment buffer (0 = mu, 1 = nu) at one step."""
    return mix_seed(0x5352, count, buffer)


def width(num_layers: int, seeds_per_layer: int) -> int:
    """The fields of a row for a model of `num_layers` layers."""
    return LAYER_FIELDS + seeds_per_layer * num_layers


def seed_field(layer: int, j: int, seeds_per_layer: int) -> int:
    """The field of `layer`'s j-th seed."""
    return LAYER_FIELDS + seeds_per_layer * layer + j


def as_int64(value: int) -> int:
    """A 64-bit value as the int64 with its bits."""
    value &= 0xFFFFFFFFFFFFFFFF
    return value - (1 << 64) if value >= 1 << 63 else value


def _f32_bits(value: float) -> int:
    return int(np.array(value, np.float32).view(np.int32))


def host_rows(count0: int, step_seeds, *, b1: float, b2: float, num_layers: int,
              seeds_per_layer: int) -> np.ndarray:
    """int64 [C, width] rows for the C steps after `count0` (counts count0 + 1
    .. count0 + C), the i-th step keyed by ``step_seeds[i]``."""
    rows = np.zeros((len(step_seeds), width(num_layers, seeds_per_layer)), np.int64)
    for i, seed in enumerate(step_seeds):
        count = count0 + 1 + i
        bc1, bc2 = bias_denominators(count, b1, b2)
        ibc1, ibc2 = bias_corrections(count, b1, b2)
        rows[i, :LAYER_FIELDS] = [
            count, _f32_bits(bc1), _f32_bits(bc2), _f32_bits(ibc1), _f32_bits(ibc2),
            as_int64(moment_seed(count, 0)), as_int64(moment_seed(count, 1)),
        ]
        for layer in range(num_layers):
            for j in range(seeds_per_layer):
                rows[i, seed_field(layer, j, seeds_per_layer)] = as_int64(mix_seed(seed, layer, j))
    return rows


def to_device(rows: np.ndarray, device) -> torch.Tensor:
    """The rows on `device`: from pinned memory without blocking the host
    towards a CUDA device (ordered on the current stream before any kernel
    that reads them). Raises under CUDA graph capture: a copy from the host
    would be frozen into the graph."""
    device = torch.device(device)
    t = torch.from_numpy(rows)
    if device.type != "cuda":
        return t.to(device)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a step's scalars must reach a captured graph through the step block, "
                           "not from the host")
    return t.pin_memory().to(device, non_blocking=True)


def build(count0: int, step_seeds, *, b1: float, b2: float, num_layers: int, device,
          seeds_per_layer: int) -> torch.Tensor:
    """``host_rows`` on `device`: int64 [C, width]."""
    return to_device(host_rows(count0, step_seeds, b1=b1, b2=b2, num_layers=num_layers,
                               seeds_per_layer=seeds_per_layer), device)


def one_row(count: int, *, b1: float, b2: float, device) -> torch.Tensor:
    """The row of the step after which the count is `count`, with no layer
    seeds: what an AdamW wrapper called with a Python int builds."""
    return build(count - 1, [0], b1=b1, b2=b2, num_layers=0, device=device, seeds_per_layer=0)[0]


def row_on(count: int | torch.Tensor, *, b1: float, b2: float, device) -> torch.Tensor:
    """The step's row on `device` for an AdamW kernel: `count` itself when it
    is a row already, else the one-row block of the int."""
    if not isinstance(count, torch.Tensor):
        return one_row(count, b1=b1, b2=b2, device=device)
    if count.device != torch.device(device) or count.dtype != torch.int64 or count.dim() != 1 \
            or count.numel() < LAYER_FIELDS or not count.is_contiguous():
        raise ValueError(f"a step row is a contiguous int64 [>= {LAYER_FIELDS}] tensor on {device}")
    return count


def count_of(count: int | torch.Tensor) -> int:
    """The count of an int or of a row on the CPU."""
    return int(count[COUNT]) if isinstance(count, torch.Tensor) else count


def seed_on(seed: int | torch.Tensor, device) -> torch.Tensor:
    """A 64-bit seed where a dropout kernel reads it: a one-element int64
    tensor on `device` (a field of a step row as it is; an int is copied
    there by ``to_device``)."""
    if isinstance(seed, torch.Tensor):
        if seed.device != torch.device(device) or seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"seed: expected a one-element int64 tensor on {device}")
        return seed
    return to_device(np.array([as_int64(int(seed))], np.int64), device)[0]


def layer_seeds(seed, layer: int, seeds_per_layer: int) -> tuple:
    """The `seeds_per_layer` dropout seeds of `layer`: ints derived on the host
    from an int step seed (``mix_seed(seed, layer, j)``), or 0-dim int64 views
    of a step row."""
    if isinstance(seed, torch.Tensor):
        return tuple(seed[seed_field(layer, j, seeds_per_layer)] for j in range(seeds_per_layer))
    return tuple(mix_seed(seed, layer, j) for j in range(seeds_per_layer))
