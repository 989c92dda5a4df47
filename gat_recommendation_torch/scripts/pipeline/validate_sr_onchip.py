"""On-card validation of the stochastic rounding (SR) of kernel 3's bf16 moments.

    python3 -m gat_recommendation_torch.scripts.pipeline.validate_sr_onchip

The port of ``scripts/pipeline/validate_sr_onchip.py`` over
``csrc/embedding_adamw.cu::sparse_adamw`` with bfloat16 moments and
stochastic rounding. The plain version draws the same bits, so the CPU tests
cannot tell a kernel whose rounding stream is broken; this checks on the
card, as the JAX script checks on the TPU:

1. the same step count gives the same bits (a resumed run rounds as the
   first did), and the next count re-rounds more than 5 % of the elements;
2. every output is one of the two bf16 neighbours of the exact float32
   moment;
3. over 2,000 steps on one touched row, nu <- b2 nu + (1 - b2) g^2 with
   g = 1, SR tracks the exact accumulator within 5 %, while round-to-nearest
   (torch's bfloat16 cast) stalls below 0.7 of it: the mechanism behind bf16
   moments losing quality.

The step count reaches the kernel through the step block in device memory
(``ops/step_block.py``), one row a step: the 2,000 steps are a plain loop of
launches over the rows of one block, with no host sync between them. Needs a
CUDA device and raises without one (no CPU mode). ``main`` returns the
numbers it prints.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gat_recommendation_torch.data.batching import UID_SENTINEL
from gat_recommendation_torch.ops import step_block
from gat_recommendation_torch.ops.sparse_adamw import sparse_adamw

HP = dict(lr=0.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
TILE = 256  # the JAX kernel's row tile: the check's table is 2 * TILE rows, as there
STEPS = 2000


def main(argv: list[str] | None = None) -> dict:
    argparse.ArgumentParser(description="On-card checks of kernel 3's stochastic rounding").parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the stochastic rounding is validated on the card only")
    dev = torch.device("cuda")
    rows, dim = 2 * TILE, 256
    rng = np.random.default_rng(0)
    table = torch.zeros(rows, dim, device=dev)
    nu0 = torch.from_numpy(np.abs(rng.normal(size=(rows, dim))).astype(np.float32) * 1e-2).to(dev)
    mu0 = torch.from_numpy(rng.normal(size=(rows, dim)).astype(np.float32) * 1e-2).to(dev)
    uid = torch.full((64,), int(UID_SENTINEL), dtype=torch.int32, device=dev)  # no touched rows: decay and SR
    summed = torch.zeros(64, dim, device=dev)
    mu_b, nu_b = mu0.to(torch.bfloat16), nu0.to(torch.bfloat16)

    def step(count: int) -> torch.Tensor:
        _, _, nu = sparse_adamw(table.clone(), mu_b.clone(), nu_b.clone(), uid, summed, count, **HP,
                                stochastic_rounding=True)
        return nu

    # 1. determinism, and a stream per count
    n5a, n5b, n6 = step(5), step(5), step(6)
    if not torch.equal(n5a.view(torch.int16), n5b.view(torch.int16)):
        raise AssertionError("the same count must give the same bits")
    frac_diff = (n5a.view(torch.int16) != n6.view(torch.int16)).float().mean().item()
    if frac_diff <= 0.05:
        raise AssertionError(f"the next count should re-round; differing share {frac_diff}")
    print(f"1. determinism OK (count-5 reproducible; count-6 differs on {frac_diff:.1%} of elements)")

    # 2. SR(b2 * nu) is one of the two bf16 neighbours of the exact float32 product
    exact = (HP["b2"] * nu_b.float().cpu().numpy()).astype(np.float32)
    bits = exact.view(np.uint32)
    lo = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    hi = ((bits & np.uint32(0xFFFF0000)) + np.uint32(0x10000)).view(np.float32)
    got = n5a.float().cpu().numpy()
    ok = (got == lo) | (got == hi)
    if not ok.all():
        raise AssertionError(f"non-adjacent SR outputs: {int((~ok).sum())}")
    took_hi = float((got == hi)[lo != hi].mean())
    print(f"2. adjacency OK (upper neighbour taken on {took_hi:.1%})")

    # 3. unbiased under accumulation: one touched row, g = 1, STEPS steps, each
    # launch reading its own row of the step block.
    touched = TILE + 3
    uid1 = uid.clone()
    uid1[0] = touched
    g = torch.zeros(64, dim, device=dev)
    g[0] = 1.0
    block = step_block.build(0, [0] * STEPS, b1=HP["b1"], b2=HP["b2"], num_layers=0, device=dev,
                             seeds_per_layer=0)
    mu = torch.zeros(rows, dim, dtype=torch.bfloat16, device=dev)
    nu = torch.zeros(rows, dim, dtype=torch.bfloat16, device=dev)
    for t in range(STEPS):
        sparse_adamw(table, mu, nu, uid1, g, block[t], **HP, stochastic_rounding=True)
    b2 = HP["b2"]
    exact_acc, nu_rne = 0.0, torch.zeros(dim)
    for _ in range(STEPS):
        exact_acc = b2 * exact_acc + (1 - b2)
        nu_rne = (b2 * nu_rne + (1 - b2)).to(torch.bfloat16).float()
    sr_val = nu[touched].float().mean().item()
    rne_val = nu_rne.mean().item()
    print(f"3. after {STEPS} steps: exact {exact_acc:.4f}  SR {sr_val:.4f}  RNE {rne_val:.4f}")
    if abs(sr_val - exact_acc) >= 0.05 * exact_acc:
        raise AssertionError("SR should track the exact accumulator")
    if rne_val >= 0.7 * exact_acc:
        raise AssertionError("round-to-nearest should stall")
    print("ALL ON-CARD SR CHECKS PASSED")
    return {"count6_rerounded": frac_diff, "upper_neighbour": took_hi, "steps": STEPS,
            "exact": exact_acc, "sr": sr_val, "rne": rne_val}


if __name__ == "__main__":
    main()
