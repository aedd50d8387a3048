"""Determinism helpers (counterpart of ``uuo_mocap_tpu/utils/random.py``)."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> torch.Generator:
    """Seed Python's and numpy's generators and return a ``torch.Generator``
    seeded with ``seed`` (on the CPU); pass it to torch's sampling calls.
    Where the JAX package returns a PRNG key, this returns the generator."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
