"""Parameters from the JAX package's tree to the port's ``state_dict``.

:func:`params_from_jax` takes the flax parameter tree of
``flowtrain_stochastic_interpolation_tpu.models.UNet3D`` or ``UNet3DCond`` as
nested dicts of numpy arrays (``{"params": ...}`` or the params alone) and
returns the ``state_dict`` of :class:`models.unet.UNet` or
:class:`models.unet_cond.UNet3DCond` with the same weights (the conditional
tree's new names, ``init_conv_ATb`` or ``downs_0_atb_mix``, hold the same kinds
of leaves). It is the reverse of the JAX package's ``convert_unet3d``, leaf by
leaf:

* conv kernels ``[k, k, k, in, out]`` (DHWIO) -> ``weight [out, in, k, k, k]``;
* Dense kernels ``[in, out]`` -> ``weight [out, in]``;
* biases, RMSNorm ``g``, ``mem_kv [2, h, n_mem, d]`` and the Fourier
  ``freqs`` / ``phases`` as they are.

It needs numpy and torch only.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_AS_IS = ("bias", "g", "mem_kv", "freqs", "phases")


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert_leaf(path: Tuple[str, ...], value: Any) -> Tuple[str, torch.Tensor]:
    arr = np.asarray(value, dtype=np.float32)
    name = path[-1]
    if name == "kernel":
        if arr.ndim == 5:      # conv DHWIO -> OIDHW
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 2:    # Dense [in, out] -> Linear [out, in]
            arr = arr.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
        name = "weight"
    elif name not in _AS_IS:
        raise KeyError(f"{'/'.join(path)}: no mapping for a leaf named {name!r}")
    key = ".".join(path[:-1] + (name,))
    return key, torch.from_numpy(arr.copy())


def params_from_jax(tree: Mapping[str, Any],
                    model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the JAX parameter tree ``tree``.

    With ``model`` given, the keys and shapes are checked against its
    ``state_dict``: a missing or an extra key raises ``KeyError``, a shape
    that differs raises ``ValueError``.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = dict(_convert_leaf(path, value) for path, value in _leaves(tree))
    if model is not None:
        expected = model.state_dict()
        missing = sorted(set(expected) - set(state))
        extra = sorted(set(state) - set(expected))
        if missing or extra:
            raise KeyError(f"parameter keys differ: missing {missing}, extra {extra}")
        for key, value in state.items():
            if tuple(value.shape) != tuple(expected[key].shape):
                raise ValueError(
                    f"{key}: shape {tuple(value.shape)} from JAX, "
                    f"{tuple(expected[key].shape)} in the model"
                )
    return state
