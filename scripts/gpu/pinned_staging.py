#!/usr/bin/env python3
"""Two ways to reuse pinned host memory for an epoch's host-to-device copies, timed on one NVIDIA GPU.

    python3 scripts/gpu/pinned_staging.py [--sessions 30000]

The items are what ``Trainer.train_epoch`` transfers on the bench corpus
(``gat_recommendation_torch.bench.make_corpus``, batches of 512 from the C++
engine): single batches with their ``GradIndex`` (chain 1) and stacked groups
of 32 batches of one node bucket (chain 32). Each item is copied to the card
on a side stream, as ``prefetch_to_device`` does, by:

- "caching": ``data/batching.to_device``, the port's path: every host tensor
  copied into a block of the CUDA caching host allocator (``pin_memory``),
  which hands a block out again once the copy out of it has finished;
- "ring": three pinned staging buffers allocated once at the largest item's
  size; an item waits for the event of its buffer's last copy, is copied
  into the buffer, and goes to the card from there.

Both in turns (caching, ring, ring, caching) over the same items: host ms per
item (the thread's time to issue an item) and ms per item until the card
holds all of them; the device copies must equal the host data. Prints one
JSON line and the nvidia-smi line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gat_recommendation_torch.bench import BATCH_SIZE, make_corpus
from gat_recommendation_torch.data.batching import (
    chain_iterator,
    iterate_batches,
    make_grad_index,
    stack_batches,
    stack_grad_indices,
    to_device,
    _tensors,
)
from gat_recommendation_torch.device import nvidia_smi


def host_tensors(item) -> list[torch.Tensor]:
    batch, gidx = item
    return [*_tensors(batch), *(torch.from_numpy(np.ascontiguousarray(a)) for a in gidx)]


class Ring:
    """Pinned staging buffers used in turn, each guarded by the event of its last copy."""

    def __init__(self, nbytes: int, slots: int = 3):
        self.buffers = [torch.empty(nbytes, dtype=torch.uint8).pin_memory() for _ in range(slots)]
        self.events = [None] * slots
        self.next = 0

    def copy(self, tensors: list[torch.Tensor], device) -> list[torch.Tensor]:
        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # the buffer's last copy has left it
        buf, out, off = self.buffers[slot], [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            staged = buf[off:off + n].view(t.dtype).view(t.shape)
            staged.copy_(t)
            out.append(staged.to(device, non_blocking=True))
            off = -(-(off + n) // 64) * 64  # 64-byte aligned slices
        self.events[slot] = torch.cuda.Event()
        self.events[slot].record()
        return out


def run(items: list, how: str, device, ring: Ring) -> tuple[float, float, list]:
    side = torch.cuda.Stream(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    with torch.cuda.stream(side):
        for item in items:
            outs.append(list(_tensors(to_device(item, device))) if how == "caching"
                        else ring.copy(host_tensors(item), device))
    issued = time.perf_counter() - t0
    side.synchronize()
    done = time.perf_counter() - t0
    return 1e3 * issued / len(items), 1e3 * done / len(items), outs


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sessions", type=int, default=30_000)
    args = p.parse_args()
    device = torch.device("cuda")
    ds, _ = make_corpus(args.sessions)
    batches = list(iterate_batches(ds, BATCH_SIZE, shuffle=True, seed=0, workers=3))
    singles = [(b, make_grad_index(b)) for b in batches]
    groups = [(stack_batches(g), stack_grad_indices([make_grad_index(b) for b in g]))
              for g in chain_iterator(batches, 32) if len(g) == 32]
    result = {"sessions": len(ds), "device": torch.cuda.get_device_name(0)}
    for label, items in (("chain_1", singles), ("chain_32", groups)):
        want = [host_tensors(x) for x in items]
        nbytes = max(sum(-(-t.numel() * t.element_size() // 64) * 64 for t in w) for w in want)
        ring = Ring(nbytes)
        runs = {"caching": [], "ring": []}
        for how in ("caching", "ring", "ring", "caching"):
            issued, done, outs = run(items, how, device, ring)
            for got, host in zip(outs, want):
                if not all(torch.equal(g.cpu(), h) for g, h in zip(got, host)):
                    raise AssertionError(f"{how}: a device copy differs from the host data")
            runs[how].append({"host_ms_per_item": issued, "ms_per_item_to_card": done})
        result[label] = {"items": len(items), "mb_per_item": statistics.mean(
            sum(t.numel() * t.element_size() for t in w) for w in want) / 1e6, **runs}
    print(json.dumps(result))
    print(nvidia_smi())


if __name__ == "__main__":
    main()
