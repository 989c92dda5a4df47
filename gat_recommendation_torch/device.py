"""Where the port's entry points run: the card unless the caller names the CPU."""

from __future__ import annotations

import subprocess
import threading

import torch

# Held while a CUDA graph is captured (``train/graphs.py``) and around every
# CUDA call of a host-to-device transfer (``data/batching.py``). Captures run
# in the default "global" mode, in which a CUDA call from any other thread
# (pinning a block, a copy, an event) fails or invalidates the capture; a
# transfer on the prefetch thread therefore waits until a capture has ended.
# One lock for the process, as that mode is process-wide.
capture_lock = threading.Lock()


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


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (what every measurement is reported beside)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]
