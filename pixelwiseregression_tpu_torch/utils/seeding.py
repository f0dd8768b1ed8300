"""Determinism helpers (mirrors ``pixelwiseregression_tpu/utils/seeding.py``).

Seeds the python and numpy RNGs that the host-side loader shuffle and the
dataset split building use, as the JAX package does, and torch's global
generator in place of JAX's PRNG key (the CLIs also pass explicit
``torch.Generator``s for the augmentation draws).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int):
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
