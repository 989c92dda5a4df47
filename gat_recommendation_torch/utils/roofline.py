"""Speed-of-light accounting: a kernel's time against the card's bound.

The bound of a kernel is the larger of its bytes over the memory rate and
its operations over the peak rate for their type. ``H100_SXM`` holds the
published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W), the
figures ``chip_smoke.py``'s ``bound_ms`` uses; a card set to a lower power
limit runs slower than these.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_tflops: float
    peak_f32_tflops: float  # outside the tensor cores
    hbm_gb_per_s: float
    hbm_gb: float


H100_SXM = ChipSpec("NVIDIA H100 SXM", 989.0, 67.0, 3350.0, 80.0)


@dataclass
class KernelRoofline:
    name: str
    flops: float
    bytes_accessed: float
    measured_seconds: float | None = None
    chip: ChipSpec = H100_SXM
    dtype_tflops: str = "f32"

    @property
    def compute_bound_seconds(self) -> float:
        peak = self.chip.peak_bf16_tflops if self.dtype_tflops == "bf16" else self.chip.peak_f32_tflops
        return self.flops / (peak * 1e12)

    @property
    def memory_bound_seconds(self) -> float:
        return self.bytes_accessed / (self.chip.hbm_gb_per_s * 1e9)

    @property
    def speed_of_light_seconds(self) -> float:
        return max(self.compute_bound_seconds, self.memory_bound_seconds)

    @property
    def bound(self) -> str:
        return "compute" if self.compute_bound_seconds >= self.memory_bound_seconds else "memory"

    @property
    def fraction_of_sol(self) -> float | None:
        """speed of light / measured (1.0 = at the bound)."""
        if self.measured_seconds is None:
            return None
        return self.speed_of_light_seconds / self.measured_seconds

    def report(self) -> dict:
        return {
            "kernel": self.name,
            "bound": self.bound,
            "sol_ms": self.speed_of_light_seconds * 1e3,
            "measured_ms": None if self.measured_seconds is None else self.measured_seconds * 1e3,
            "fraction_of_sol": self.fraction_of_sol,
            "arithmetic_intensity": self.flops / max(self.bytes_accessed, 1.0),
        }


def embedding_adamw_roofline(num_items: int, dim: int, measured_seconds=None) -> KernelRoofline:
    """The dense AdamW kernel: 4 reads and 3 writes of the [V, D] float32 table."""
    return KernelRoofline("embedding_adamw", flops=num_items * dim * 12,
                          bytes_accessed=7 * num_items * dim * 4, measured_seconds=measured_seconds)


def scorer_roofline(batch: int, num_items: int, dim: int, measured_seconds=None) -> KernelRoofline:
    """Full-catalog scoring: the [B, D] x [D, V] float32 product and the
    table read, scores written and read by the selection."""
    return KernelRoofline("score_chunkmax", flops=2.0 * batch * num_items * dim,
                          bytes_accessed=(num_items * dim + batch * dim + 2 * batch * num_items) * 4,
                          measured_seconds=measured_seconds)
