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

:func:`params_to_jax` is its reverse, from a ``state_dict`` to the flax tree.

The release-weights format of the JAX package (``save_release_weights`` /
``load_release_weights``: a directory with ``weights.msgpack``, ``config.json``
and ``meta.json``) is read and written by :mod:`utils.msgpack_tree`, without
flax or msgpack; :func:`state_dict_from_release` turns such a tree into the
port's ``state_dict``. The Lightning ``.ckpt`` conversion of the JAX package
(``load_lightning_checkpoint``, ``convert_lightning_module``) is not ported.

It needs numpy and torch only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.utils.msgpack_tree import (
    Bfloat16,
    packb,
    to_bfloat16,
    unpackb,
)

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


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The flax parameter tree (nested dicts of f32 numpy arrays) of the port's
    ``state_dict``: the reverse of :func:`params_from_jax`, leaf by leaf."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        arr = value.detach().cpu().float().numpy()
        if name == "weight":
            if arr.ndim == 5:      # conv OIDHW -> DHWIO
                arr = arr.transpose(2, 3, 4, 1, 0)
            elif arr.ndim == 2:    # Linear [out, in] -> Dense [in, out]
                arr = arr.T
            else:
                raise ValueError(f"{key}: weight of rank {arr.ndim}")
            name = "kernel"
        elif name not in _AS_IS:
            raise KeyError(f"{key}: no mapping for a leaf named {name!r}")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


# --------------------------------------------------------------------------
# Plain tree persistence and the release-weights format
# --------------------------------------------------------------------------
def _same_keys(template: Any, tree: Any, path: str = "") -> None:
    if isinstance(template, Mapping):
        if not isinstance(tree, Mapping) or set(map(str, template)) != set(tree):
            raise ValueError(f"the saved tree's keys at {path or '/'} differ from the template's")
        for key, value in template.items():
            _same_keys(value, tree[str(key)], f"{path}/{key}")


def save_model(variables: Mapping[str, Any], path: str) -> None:
    """Write a tree of dicts and numpy arrays in flax's msgpack format (the JAX
    package's ``save_model``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(variables))


def load_model(template: Optional[Mapping[str, Any]], path: str) -> Dict[str, Any]:
    """Read a tree written by :func:`save_model` (or flax's ``to_bytes``); with a
    ``template``, its dict keys must be the saved tree's, as flax's
    ``from_bytes`` requires."""
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if template is not None:
        _same_keys(template, tree)
    return tree


def _cast_floats(tree: Any, cast) -> Any:
    """Float leaves (``Bfloat16`` included) cast by ``cast``; dict keys sorted,
    as the JAX package's ``jax.tree.map`` leaves them."""
    if isinstance(tree, Mapping):
        return {key: _cast_floats(tree[key], cast) for key in sorted(tree)}
    if isinstance(tree, Bfloat16) or np.issubdtype(np.asarray(tree).dtype, np.floating):
        return cast(tree)
    return np.asarray(tree)


def _as_float32(leaf) -> np.ndarray:
    return leaf.to_float32() if isinstance(leaf, Bfloat16) else np.asarray(leaf, np.float32)


def save_release_weights(directory: str, *, params: Any, ema_params: Any = None,
                         model_constants: Any = None, config_json: Optional[str] = None,
                         step: Optional[int] = None, dtype="bfloat16", note: str = "") -> None:
    """Export trained weights as the JAX package's release directory:
    ``weights.msgpack`` (``{"params", "ema_params", "constants"}``, float leaves
    in ``dtype``, bf16 rounded to nearest even), ``config.json`` and
    ``meta.json``. ``params`` is the flax tree (:func:`params_to_jax`)."""
    os.makedirs(directory, exist_ok=True)
    if str(dtype) == "bfloat16":
        cast = lambda leaf: to_bfloat16(_as_float32(leaf))
    else:
        cast = _as_float32
    tree = {
        "params": _cast_floats(params, cast),
        "ema_params": _cast_floats(ema_params, cast) if ema_params is not None else {},
        "constants": dict(model_constants or {}),
    }
    save_model(tree, os.path.join(directory, "weights.msgpack"))
    if config_json is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            f.write(config_json)
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"step": step, "dtype": str(dtype), "note": note}, f, indent=1)


def load_release_weights(directory: str, cast_to=np.float32
                         ) -> Tuple[Dict[str, Any], Optional[ExperimentConfig], Dict[str, Any]]:
    """``(tree, config or None, meta)`` of a release directory. Float leaves are
    cast to ``cast_to`` (bf16 widened exactly); with ``cast_to=None`` a bf16
    leaf stays a :class:`utils.msgpack_tree.Bfloat16`."""
    with open(os.path.join(directory, "weights.msgpack"), "rb") as f:
        tree = unpackb(f.read())
    if cast_to is not None:
        tree = _cast_floats(tree, lambda leaf: _as_float32(leaf).astype(cast_to))
    config = None
    cfg_path = os.path.join(directory, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = ExperimentConfig.from_json(f.read())
    meta = {}
    meta_path = os.path.join(directory, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, config, meta


def is_release_weights_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "weights.msgpack"))


def state_dict_from_release(tree: Mapping[str, Any], model: Optional[nn.Module] = None,
                            use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a release tree: ``ema_params`` when
    ``use_ema`` and the tree has any (the flagship release has none: it was
    trained with EMA off), else ``params``, with the ``constants`` collection's
    leaves beside them where there are any. Checked against ``model`` as
    :func:`params_from_jax` checks."""
    params = tree["ema_params"] if use_ema and tree.get("ema_params") else tree["params"]
    params = _cast_floats(params, _as_float32)
    for path, value in _leaves(_cast_floats(tree.get("constants") or {}, _as_float32)):
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return params_from_jax(params, model)
