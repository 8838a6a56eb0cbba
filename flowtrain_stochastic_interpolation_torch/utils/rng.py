"""Seeds folded from tuples of integers: the port's counterpart of JAX's
``fold_in``, for streams that must not depend on what ran before them."""

from __future__ import annotations

import numpy as np
import torch


def fold_seed(*ints: int) -> int:
    """A 63-bit seed that depends on every one of ``ints`` (numpy's SeedSequence)."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def generator(device, *ints: int) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with ``fold_seed(*ints)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(*ints))
    return gen
