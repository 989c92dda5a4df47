"""Deterministic seeding of the host's generators and torch's."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed ``random``, numpy's global generator and torch's (every device's),
    set ``PYTHONHASHSEED`` for child processes, and return a CPU
    ``torch.Generator`` seeded with `seed` for explicit draws."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
