"""The small velocity MLP of the 2-D toy experiment.

Port of ``flowtrain_stochastic_interpolation_tpu/models/mlp.py::VelocityMLP``:
``(x [B, in_dim], t [B]) -> dx/dt [B, out_dim]`` through a LearnedFourier time
embedding (bandwidth 3), the state and the embedding concatenated, Dense
layers with SiLU between them and a last Dense. The submodules carry flax's
automatic names (``LearnedFourierEmbedding_0``, ``Dense_0``, ...), so a JAX
parameter tree maps onto the ``state_dict`` (:func:`models.persistence.params_from_jax`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from flowtrain_stochastic_interpolation_torch.models.layers import (
    Dense,
    LearnedFourierEmbedding,
)


class VelocityMLP(nn.Module):
    """Velocity of a ``in_dim``-dimensional state; ``hidden`` widths, each
    followed by SiLU, then a Dense to ``out_dim``."""

    def __init__(self, hidden: Sequence[int] = (128, 128, 128), out_dim: int = 2,
                 time_features: int = 32, in_dim: int = 2, device=None):
        super().__init__()
        self.LearnedFourierEmbedding_0 = LearnedFourierEmbedding(time_features, bandwidth=3.0,
                                                                 device=device)
        widths = [in_dim + time_features, *hidden, out_dim]
        self.n_dense = len(widths) - 1
        for i in range(self.n_dense):
            setattr(self, f"Dense_{i}", Dense(widths[i], widths[i + 1], device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded flax-style initialisation of every parameter."""
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x, self.LearnedFourierEmbedding_0(t)], dim=-1)
        for i in range(self.n_dense - 1):
            h = F.silu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.n_dense - 1}")(h)
