"""Sparse AdamW over the item-embedding table, one pass, in place.

The table gradient arrives pre-reduced as ``(uid, summed)``: ascending unique
GLOBAL row ids with a ``UID_SENTINEL`` tail (``data/batching.py``), and the
summed gradient row of each (the row of id 0, the padding item, already
zeroed by the caller). Every row of the table decays; the rows named by
``uid`` also take their gradient. The contribution is added BEFORE the decay
multiply, pre-divided by the decay factor, so one multiply yields
``b*m + (1-b)*g`` for touched rows and ``b*m`` for the rest:

    mu = b1 * (mu + (1-b1)/b1 * s),  nu = b2 * (nu + (1-b2)/b2 * s*s)
    w  = w - lr * (mu*ibc1 / (sqrt(nu*ibc2) + eps) + wd*w)

which is exactly AdamW. ``row_offset`` is the first global row of ``table``
when it is one row shard of the full table; uid values outside
``[row_offset, row_offset + rows)``, the sentinel included, touch nothing.

``sparse_adamw`` is the wrapper: on CUDA tensors it launches the hand-written
kernel ``csrc/embedding_adamw.cu::sparse_adamw`` (which replaces the JAX
package's Pallas kernel ``ops/pallas/sparse_adamw.py::fused_sparse_adamw``)
or raises; on CPU tensors it runs the plain version
``sparse_adamw_reference``. Both update ``table``, ``mu`` and ``nu`` IN PLACE
and return them. Each row finds its slot by a binary search of ``uid`` inside
the kernel; nothing is searched outside it. Unlike the Pallas kernel, which
holds the summed rows in on-chip memory, the port's takes any number of uid
slots and any row count. Moment storage, bias corrections and ``count`` are
as in ``ops/embedding_adamw.py``.
"""

from __future__ import annotations

import torch

from gat_recommendation_torch.ops import _build
from gat_recommendation_torch.ops.embedding_adamw import (
    adamw_lib,
    adamw_tail,
    bias_corrections,
    check_table_args,
    moment_seed,
    stochastic_flags,
    store_moment,
)


def sparse_adamw_reference(
    table: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    uid: torch.Tensor,
    summed: torch.Tensor,
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
    """Plain PyTorch version; updates table, mu, nu in place and returns them."""
    sr_mu, sr_nu = stochastic_flags(mu, nu, stochastic_rounding)
    ibc1, ibc2 = bias_corrections(count, b1, b2)
    rows, dim = table.shape
    local = uid.long() - row_offset
    # The sentinel tail and other shards' ids go to a spare row that is cut off
    # again: no shape depends on the data, so nothing waits for the device.
    # uid is unique, so every real row is added to once: the order is fixed.
    slot = torch.where((local >= 0) & (local < rows), local, torch.full_like(local, rows))
    spare = table.new_zeros(1, dim)
    m = torch.cat([mu.float(), spare]).index_add_(0, slot, (1.0 - b1) / b1 * summed)[:rows]
    n = torch.cat([nu.float(), spare]).index_add_(0, slot, (1.0 - b2) / b2 * (summed * summed))[:rows]
    m = b1 * m
    n = b2 * n
    table.copy_(adamw_tail(table, m, n, ibc1, ibc2, lr, eps, weight_decay))
    store_moment(mu, m, sr_mu, moment_seed(count, 0), row_offset)
    store_moment(nu, n, sr_nu, moment_seed(count, 1), row_offset)
    return table, mu, nu


def sparse_adamw(
    table: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    uid: torch.Tensor,
    summed: torch.Tensor,
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
    """AdamW over the whole table with sparse contributions, in one pass.

    table: float32 [rows, D]; mu, nu: float32 or bfloat16 [rows, D]; uid:
    int32 [U] ascending unique global ids, sentinel-padded; summed: float32
    [U, D]; `count`: the step number after this update.
    """
    if table.device.type == "cpu":
        return sparse_adamw_reference(
            table, mu, nu, uid, summed, count, lr=lr, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, row_offset=row_offset,
            stochastic_rounding=stochastic_rounding,
        )
    if table.device.type != "cuda":
        raise ValueError(f"sparse_adamw runs on cuda or cpu tensors, got {table.device}")
    check_table_args("sparse_adamw", table, mu, nu)
    if uid.dim() != 1 or uid.dtype != torch.int32 or uid.device != table.device:
        raise ValueError(f"sparse_adamw: uid must be int32 [U] on {table.device}")
    want = (uid.shape[0], table.shape[1])
    if summed.shape != want or summed.dtype != torch.float32 or summed.device != table.device:
        raise ValueError(f"sparse_adamw: summed must be float32 {want} on {table.device}")
    for label, t in (("uid", uid), ("summed", summed)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"sparse_adamw: {label} must be contiguous and 16-byte aligned")
    sr_mu, sr_nu = stochastic_flags(mu, nu, stochastic_rounding)
    ibc1, ibc2 = bias_corrections(count, b1, b2)
    with torch.cuda.device(table.device):
        err = adamw_lib().sparse_adamw(
            table.data_ptr(), mu.data_ptr(), nu.data_ptr(), uid.data_ptr(), summed.data_ptr(),
            uid.shape[0], table.shape[0], table.shape[1], row_offset,
            mu.dtype == torch.bfloat16, nu.dtype == torch.bfloat16, sr_mu, sr_nu,
            moment_seed(count, 0), moment_seed(count, 1),
            lr, b1, b2, eps, weight_decay, (1.0 - b1) / b1, (1.0 - b2) / b2, ibc1, ibc2,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sparse_adamw")
    sparse_adamw.launches += 1
    return table, mu, nu


sparse_adamw.launches = 0
