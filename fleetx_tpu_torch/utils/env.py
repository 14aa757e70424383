"""Seeding (port of ``fleetx_tpu/utils/env.py:71`` ``set_seed``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed numpy and ``random`` and return a CPU ``torch.Generator``
    seeded with ``seed``: the port passes generators explicitly instead
    of seeding torch's global one."""
    random.seed(seed)
    np.random.seed(seed)
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return gen
