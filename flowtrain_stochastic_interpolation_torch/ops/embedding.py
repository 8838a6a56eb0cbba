"""Categorical simplex embedding and cosine decoding.

Port of ``flowtrain_stochastic_interpolation_tpu/ops/embedding.py``:

* the embedding table is the ``n_cats``-point regular simplex, centred at the
  origin of ``n_dims``-space and row-normalised;
* ``embed`` maps ``[B, X, Y, Z]`` categorical indices (air = -1, so indices
  are shifted by +1) to channels-last ``[B, X, Y, Z, E]`` vectors;
* ``decode`` is nearest-neighbour cosine similarity (argmax over the logits).
"""

from __future__ import annotations

import numpy as np
import torch


def simplex_embedding(n_cats: int, n_dims: int) -> np.ndarray:
    """Origin-centred, row-normalised simplex embedding table [n_cats, n_dims]."""
    if n_dims < n_cats:
        raise ValueError("embedding dim must be >= number of categories")
    m = np.zeros((n_cats, n_dims), dtype=np.float32)
    m[:, :n_cats] = np.eye(n_cats, dtype=np.float32)
    m[:, :n_cats] -= 1.0 / n_cats
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m


def embed(indices: torch.Tensor, table: torch.Tensor, index_offset: int = 1) -> torch.Tensor:
    """Categorical ``[B, *spatial]`` (or with trailing 1-channel) -> ``[B, *spatial, E]``."""
    if indices.shape[-1] == 1 and indices.ndim > table.ndim:
        indices = indices[..., 0]
    return table[indices.long() + index_offset]


def decode_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity logits ``[..., n_cats]`` for embedded data ``[..., E]``.

    Taken in float32 whatever the state's dtype.
    """
    x = x.float()
    table = table.to(device=x.device, dtype=torch.float32)
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    tn = table / torch.linalg.vector_norm(table, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.einsum("...e,ce->...c", xn, tn)


def decode(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour cosine decode: ``[..., E]`` -> int64 ``[...]`` (0-based rows)."""
    return torch.argmax(decode_logits(x, table), dim=-1)
