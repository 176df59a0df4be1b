"""Deterministic seeding (port of ``mpmc_tpu/utils/seed.py``; reference
``seed_everything``, ``Multimodal_example_task2C.py:42-48``)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 42,
                    device: str = "cpu") -> torch.Generator:
    """Seed the host RNGs (python, numpy, ``PYTHONHASHSEED``) and return a
    ``torch.Generator`` on ``device`` seeded with ``seed``, the counterpart
    of the JAX package's root key: the port passes explicit generators to
    the draws that must repeat (dropout, augmentation)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator(device=device).manual_seed(seed)
