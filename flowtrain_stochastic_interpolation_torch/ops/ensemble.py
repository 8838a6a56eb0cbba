"""Ensemble analysis of a set of decoded categorical volumes.

Port of ``flowtrain_stochastic_interpolation_tpu/ops/ensemble.py``: one-hot
voting over an ensemble of decoded volumes gives per-voxel category
probabilities; from them the entropy, the most probable model, one category's
probability volume (the dikes) and the entropy with confident air zeroed.
Volumes use the GeoGen convention (air = -1), shifted by ``index_offset``
onto the probability axis.
"""

from __future__ import annotations

import torch


def vote_probabilities(solutions: torch.Tensor, n_cats: int,
                       index_offset: int = 1) -> torch.Tensor:
    """``[S, ...]`` integer volumes -> ``[..., n_cats]`` f32 probabilities (the mean
    one-hot over the S members)."""
    cats = torch.arange(n_cats, device=solutions.device)
    onehot = ((solutions.long() + index_offset)[..., None] == cats).to(torch.float32)
    return onehot.mean(dim=0)


def entropy(probs: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-voxel Shannon entropy ``-sum p log p`` over the category axis."""
    return -(probs * torch.log(probs.clamp(eps, 1.0))).sum(dim=-1)


def most_probable_model(probs: torch.Tensor, index_offset: int = 1) -> torch.Tensor:
    """The arg-max category per voxel (the first on a tie), back in the air = -1
    convention."""
    return torch.argmax(probs, dim=-1) - index_offset


def category_probability(probs: torch.Tensor, category: int,
                         index_offset: int = 1) -> torch.Tensor:
    """The probability volume of one category (e.g. dikes)."""
    return probs[..., category + index_offset]


def air_masked_entropy(probs: torch.Tensor, index_offset: int = 1,
                       air_threshold: float = 0.5) -> torch.Tensor:
    """Entropy with the voxels that are air with probability above
    ``air_threshold`` set to 0."""
    ent = entropy(probs)
    air_prob = probs[..., 0] if index_offset == 1 else probs[..., -1]
    return torch.where(air_prob > air_threshold, torch.zeros_like(ent), ent)
