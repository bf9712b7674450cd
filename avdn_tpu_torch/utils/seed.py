"""Seeding (the port's copy of ``avdn_tpu/utils/seed.py``; reference
src/utils/misc.py:5-12 minus the torch calls — the port's randomness comes
from explicit ``torch.Generator``s, so only host-side RNGs need seeding)."""

import random

import numpy as np


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
