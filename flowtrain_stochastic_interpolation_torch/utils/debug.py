"""Numerical-safety helpers.

Port of ``flowtrain_stochastic_interpolation_tpu/utils/debug.py``:

* :func:`enable_nan_checking`: autograd's anomaly mode
  (``torch.autograd.set_detect_anomaly``), where JAX sets ``jax_debug_nans``:
  a backward that produces NaN raises, naming the forward operation;
* :func:`check_finite`: raises ``FloatingPointError`` naming the first
  non-finite leaf of a tree (dicts, lists and tuples of tensors or arrays);
* :func:`grad_health`: JAX's three gradient statistics, ``grad_norm``,
  ``grad_max_abs`` and ``grad_finite_frac``, as 0-d tensors on the gradients'
  device (no host read).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def enable_nan_checking(enable: bool = True) -> None:
    """Autograd's anomaly mode on (or off) for this process."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + (str(i),))
    elif tree is not None:
        yield path, tree


def check_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` at the first leaf of ``tree`` with a NaN or
    an infinity, naming it ``name:key/key/...``."""
    for path, leaf in _leaves(tree):
        finite = (bool(torch.isfinite(leaf).all()) if isinstance(leaf, torch.Tensor)
                  else bool(np.isfinite(np.asarray(leaf)).all()))
        if not finite:
            raise FloatingPointError(f"non-finite values in {name}:{'/'.join(path)}")


def grad_health(grads: Any) -> Dict[str, torch.Tensor]:
    """``grad_norm`` (the global L2 norm, in f32), ``grad_max_abs`` and
    ``grad_finite_frac`` of the tensors of ``grads``."""
    leaves = [leaf for _, leaf in _leaves(grads)]
    total = sum(torch.sum(torch.square(g.float())) for g in leaves)
    max_abs = torch.max(torch.stack([torch.max(torch.abs(g)).float() for g in leaves]))
    finite = sum(torch.sum(torch.isfinite(g)) for g in leaves)
    count = sum(g.numel() for g in leaves)
    return {"grad_norm": torch.sqrt(total), "grad_max_abs": max_abs,
            "grad_finite_frac": finite / count}
