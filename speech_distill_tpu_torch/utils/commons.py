"""Global seeding (own copy of ``speech_distill_tpu/utils/commons.py``;
reference soulxpodcast/utils/commons.py:6-10)."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_all_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
