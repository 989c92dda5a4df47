"""Where the port's entry points run: the card unless the caller names the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or ``cuda`` when None; raises if ``cuda`` is asked for and absent.

    The model factories, the ``Trainer`` and the ``Recommender`` all resolve
    their `device` argument here, so none of them lands on the CPU quietly:
    the CPU only when the caller passes ``device="cpu"`` (or ``"meta"`` for a
    module that a checkpoint will fill).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
