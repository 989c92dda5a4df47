"""Compute ops: the masked dense primitives, and the wrappers of the CUDA
kernels of ``csrc/`` (each built at its first launch, never at import). The
JAX package's ``ops.__all__``."""

from gat_recommendation_torch.ops.masked import (
    masked_batch_norm,
    masked_max,
    masked_mean,
    masked_softmax,
)

__all__ = ["masked_softmax", "masked_mean", "masked_max", "masked_batch_norm"]
