"""Parameters from the JAX package's tree to the port's ``state_dict``.

:func:`params_from_jax` takes the flax parameter tree of
``flowtrain_stochastic_interpolation_tpu.models.UNet3D`` or ``UNet3DCond`` as
nested dicts of numpy arrays (``{"params": ...}`` or the params alone) and
returns the ``state_dict`` of :class:`models.unet.UNet` or
:class:`models.unet_cond.UNet3DCond` with the same weights (the conditional
tree's new names, ``init_conv_ATb`` or ``downs_0_atb_mix``, hold the same kinds
of leaves). It is the reverse of the JAX package's ``convert_unet3d``, leaf by
leaf:

* conv kernels ``[k, k, k, in, out]`` (DHWIO) -> ``weight [out, in, k, k, k]``,
  and in 2-D ``[k, k, in, out]`` (HWIO) -> ``[out, in, k, k]``;
* Dense kernels ``[in, out]`` -> ``weight [out, in]``;
* biases, RMSNorm ``g``, ``mem_kv [2, h, n_mem, d]`` and the Fourier
  ``freqs`` / ``phases`` as they are.

:func:`params_to_jax` is its reverse, from a ``state_dict`` to the flax tree.

The release-weights format of the JAX package (``save_release_weights`` /
``load_release_weights``: a directory with ``weights.msgpack``, ``config.json``
and ``meta.json``) is read and written by :mod:`utils.msgpack_tree`, without
flax or msgpack; :func:`state_dict_from_release` turns such a tree into the
port's ``state_dict``. :func:`variables_to_jax` gives a model's flax variables,
its buffers as the ``constants`` collection.

The reference's Lightning ``.ckpt`` files are read by
:func:`load_lightning_checkpoint` and converted by
:func:`convert_lightning_module` (with :func:`convert_unet3d`,
:func:`convert_unet3d_cond` and :class:`_Mapper`), the JAX package's rules
copied as numpy code: the result is the JAX converter's own, the
``{"params", "constants", "embedding"}`` tree with flax names and layouts, which
:func:`params_from_jax` then maps onto the port's modules.

It needs numpy and torch only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

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
        elif arr.ndim == 4:    # 2-D conv HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
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
    """The port's ``state_dict`` for the JAX parameter tree ``tree``: the params
    alone, or a variables dict ``{"params", "constants"}`` whose ``constants``
    (RandomFourier's frozen ``freqs`` and ``phases``) become the buffers.

    With ``model`` given, the keys and shapes are checked against its
    ``state_dict``: a missing or an extra key raises ``KeyError``, a shape
    that differs raises ``ValueError``.
    """
    if "params" in tree and set(tree) <= {"params", "constants"}:
        tree = _merged(tree["params"], tree.get("constants") or {})
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


def _merged(params: Mapping[str, Any], constants: Mapping[str, Any]) -> Dict[str, Any]:
    """The params tree with the constants' leaves beside them (new dicts; the
    leaves are shared)."""
    out = {key: (_merged(value, {}) if isinstance(value, Mapping) else value)
           for key, value in params.items()}
    for path, value in _leaves(constants):
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return out


def variables_to_jax(model: nn.Module) -> Dict[str, Any]:
    """The flax variables of ``model``: ``{"params": ...}`` from its parameters,
    and ``"constants"`` from its buffers where it has any (a RandomFourier
    time embedding's), each converted by :func:`params_to_jax`."""
    variables = {"params": params_to_jax(dict(model.named_parameters()))}
    buffers = dict(model.named_buffers())
    if buffers:
        variables["constants"] = params_to_jax(buffers)
    return variables


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
            elif arr.ndim == 4:    # 2-D conv OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
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
# The reference's Lightning checkpoints
# --------------------------------------------------------------------------
def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _conv(w) -> np.ndarray:
    """torch conv kernel [out, in, k...] -> flax [k..., in, out]."""
    w = _np(w)
    nd = w.ndim - 2
    return np.transpose(w, (*range(2, 2 + nd), 1, 0))


def _dense_from_conv1(w) -> np.ndarray:
    """torch 1×1 conv [out, in, 1...] -> flax Dense kernel [in, out]."""
    w = _np(w)
    return w.reshape(w.shape[0], w.shape[1]).T


def _unflatten(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


class _Mapper:
    """Collects the flat ``{flax path: array}`` of a reference state dict; the
    frozen RandomFourier features go to ``constants``. ``used`` names every
    key read."""

    def __init__(self, sd: Mapping[str, Any], src_prefix: str = ""):
        self.sd = sd
        self.src_prefix = src_prefix
        self.out: Dict[Tuple[str, ...], np.ndarray] = {}
        self.constants: Dict[Tuple[str, ...], np.ndarray] = {}
        self.used = set()

    def _get(self, key: str):
        full = self.src_prefix + key
        self.used.add(full)
        return self.sd[full]

    def has(self, key: str) -> bool:
        return (self.src_prefix + key) in self.sd

    def put(self, dst: str, value: np.ndarray) -> None:
        self.out[tuple(dst.split("/"))] = value

    def put_const(self, dst: str, value: np.ndarray) -> None:
        self.constants[tuple(dst.split("/"))] = value

    def conv(self, src: str, dst: str, *, dense: bool = False) -> None:
        w = self._get(f"{src}.weight")
        self.put(f"{dst}/kernel", _dense_from_conv1(w) if dense else _conv(w))
        if self.has(f"{src}.bias"):
            self.put(f"{dst}/bias", _np(self._get(f"{src}.bias")))

    def linear(self, src: str, dst: str) -> None:
        self.put(f"{dst}/kernel", _np(self._get(f"{src}.weight")).T)
        if self.has(f"{src}.bias"):
            self.put(f"{dst}/bias", _np(self._get(f"{src}.bias")))

    def rmsnorm(self, src: str, dst: str) -> None:
        self.put(f"{dst}/g", _np(self._get(f"{src}.g")).reshape(-1))

    def resnet(self, src: str, dst: str) -> None:
        """ResnetBlock; the conditional variants name its time MLP ``time_mlp``."""
        if self.has(f"{src}.mlp.1.weight"):
            self.linear(f"{src}.mlp.1", f"{dst}/mlp")
        elif self.has(f"{src}.time_mlp.1.weight"):
            self.linear(f"{src}.time_mlp.1", f"{dst}/mlp")
        self.conv(f"{src}.block1.proj", f"{dst}/block1/proj")
        self.rmsnorm(f"{src}.block1.norm", f"{dst}/block1/norm")
        self.conv(f"{src}.block2.proj", f"{dst}/block2/proj")
        self.rmsnorm(f"{src}.block2.norm", f"{dst}/block2/norm")
        if self.has(f"{src}.res_conv.weight"):
            self.conv(f"{src}.res_conv", f"{dst}/res_conv", dense=True)

    def linear_attn(self, src: str, dst: str) -> None:
        """LinearAttention; mem_kv [2, h, d, n] -> [2, h, n, d]."""
        self.rmsnorm(f"{src}.norm", f"{dst}/norm")
        self.put(f"{dst}/mem_kv", np.transpose(_np(self._get(f"{src}.mem_kv")), (0, 1, 3, 2)))
        self.conv(f"{src}.to_qkv", f"{dst}/to_qkv", dense=True)
        self.conv(f"{src}.to_out.0", f"{dst}/to_out", dense=True)
        self.rmsnorm(f"{src}.to_out.1", f"{dst}/out_norm")

    def full_attn(self, src: str, dst: str) -> None:
        """Attention; mem_kv already [2, h, n, d]."""
        self.rmsnorm(f"{src}.norm", f"{dst}/norm")
        self.put(f"{dst}/mem_kv", _np(self._get(f"{src}.mem_kv")))
        self.conv(f"{src}.to_qkv", f"{dst}/to_qkv", dense=True)
        self.conv(f"{src}.to_out", f"{dst}/to_out", dense=True)

    def attn(self, src: str, dst: str, full: bool) -> None:
        (self.full_attn if full else self.linear_attn)(src, dst)

    def embed_atb(self, src: str, dst: str) -> None:
        self.conv(f"{src}.conv1", f"{dst}/conv1")
        self.conv(f"{src}.conv2", f"{dst}/conv2")

    def mix_atb(self, src: str, dst: str) -> None:
        if self.has(f"{src}.time_mlp.1.weight"):
            self.linear(f"{src}.time_mlp.1", f"{dst}/time_mlp")
        self.conv(f"{src}.conv1", f"{dst}/conv1")
        self.rmsnorm(f"{src}.norm", f"{dst}/norm")
        self.conv(f"{src}.conv2", f"{dst}/conv2")

    def time_mlp(self, src: str, dst: str, *, sin_pos: bool, learned: bool) -> None:
        """Sequential(embed, Linear, GELU, Linear): the sinusoidal embedding has
        nothing to map, LearnedFourier's features are params, RandomFourier's
        (frozen, still in the state dict) go to ``constants``."""
        if not sin_pos:
            put = self.put if learned else self.put_const
            put(f"{dst}/embed/freqs", _np(self._get(f"{src}.0.freqs")))
            put(f"{dst}/embed/phases", _np(self._get(f"{src}.0.phases")))
        self.linear(f"{src}.1", f"{dst}/fc1")
        self.linear(f"{src}.3", f"{dst}/fc2")


def _resolve_full_attn(full_attn, n_stages: int) -> Tuple[bool, ...]:
    if full_attn:
        return tuple(full_attn)
    return (False,) * (n_stages - 1) + (True,)


def _finish(m: _Mapper, return_constants: bool):
    params = _unflatten(m.out)
    return (params, _unflatten(m.constants)) if return_constants else params


def convert_unet3d(sd: Mapping[str, Any], *, n_stages: int,
                   full_attn: Optional[Sequence[bool]] = None, attn_enabled: bool = True,
                   time_sin_pos: bool = False, time_learned_emb: bool = True,
                   src_prefix: str = "", ndim: int = 3, return_constants: bool = False) -> Any:
    """The reference ``Unet3D`` state dict (``Unet2D``'s with ``ndim=2``) as flax
    params (and, with ``return_constants``, the ``constants`` collection). Each
    stage's module list is [res1, res2, attn, resample]; a 2-D resample is a
    Sequential whose second module holds the weights (the space-to-depth 1×1
    conv down, the 3×3 conv after the nearest upsampling up)."""
    m = _Mapper(sd, src_prefix)
    fa = _resolve_full_attn(full_attn, n_stages)
    resample = "3.conv" if ndim == 3 else "3.1"
    m.conv("init_conv", "init_conv")
    m.time_mlp("time_mlp", "time_mlp", sin_pos=time_sin_pos, learned=time_learned_emb)
    for i in range(n_stages):
        m.resnet(f"downs.{i}.0", f"downs_{i}_block1")
        m.resnet(f"downs.{i}.1", f"downs_{i}_block2")
        if attn_enabled:
            m.attn(f"downs.{i}.2", f"downs_{i}_attn", fa[i])
        if i >= n_stages - 1:
            m.conv(f"downs.{i}.3", f"downs_{i}_downsample")
        else:
            m.conv(f"downs.{i}.{resample}", f"downs_{i}_downsample/conv", dense=True)
    m.resnet("mid_block1", "mid_block1")
    if attn_enabled:
        m.full_attn("mid_attn", "mid_attn")
    m.resnet("mid_block2", "mid_block2")
    fa_r = fa[::-1]
    for i in range(n_stages):
        m.resnet(f"ups.{i}.0", f"ups_{i}_block1")
        m.resnet(f"ups.{i}.1", f"ups_{i}_block2")
        if attn_enabled:
            m.attn(f"ups.{i}.2", f"ups_{i}_attn", fa_r[i])
        if i == n_stages - 1:
            m.conv(f"ups.{i}.3", f"ups_{i}_upsample")
        else:
            m.conv(f"ups.{i}.{resample}", f"ups_{i}_upsample/conv")
    m.resnet("final_res_block", "final_res_block")
    m.conv("final_conv", "final_conv", dense=True)
    return _finish(m, return_constants)


def convert_unet3d_cond(sd: Mapping[str, Any], *, n_stages: int,
                        full_attn: Optional[Sequence[bool]] = None, attn_enabled: bool = True,
                        time_sin_pos: bool = False, time_learned_emb: bool = True,
                        src_prefix: str = "", variant: str = "v3",
                        return_constants: bool = False) -> Any:
    """The reference ``Unet3DCond`` state dict as flax params. Stage module
    lists: v3 [EmbedATb, MixATb, res1, res2, attn, resample] on both paths; v2
    [EmbedMixATb, res1, ...], whose combined module's ``embed_`` / ``mix_``
    convs map onto EmbedATb and a MixATb without norm and FiLM; v1 [EmbedATb,
    res1, ...] down and no conditioning up."""
    m = _Mapper(sd, src_prefix)
    fa = _resolve_full_attn(full_attn, n_stages)
    m.conv("init_conv_ATb", "init_conv_ATb")
    m.conv("init_conv_x", "init_conv_x")
    m.time_mlp("time_mlp", "time_mlp", sin_pos=time_sin_pos, learned=time_learned_emb)

    def fuse_modules(src: str, dst: str) -> int:
        """Map a stage's conditioning modules; the index of its first ResnetBlock."""
        if variant == "v3":
            m.embed_atb(f"{src}.0", f"{dst}_atb_embed")
            m.mix_atb(f"{src}.1", f"{dst}_atb_mix")
            return 2
        if variant == "v2":
            m.conv(f"{src}.0.embed_conv1", f"{dst}_atb_embed/conv1")
            m.conv(f"{src}.0.embed_conv2", f"{dst}_atb_embed/conv2")
            m.conv(f"{src}.0.mix_conv1", f"{dst}_atb_mix/conv1")
            m.conv(f"{src}.0.mix_conv2", f"{dst}_atb_mix/conv2")
            return 1
        m.embed_atb(f"{src}.0", f"{dst}_atb_embed")
        return 1

    for i in range(n_stages):
        off = fuse_modules(f"downs.{i}", f"downs_{i}")
        m.resnet(f"downs.{i}.{off}", f"downs_{i}_block1")
        m.resnet(f"downs.{i}.{off + 1}", f"downs_{i}_block2")
        if attn_enabled:
            m.attn(f"downs.{i}.{off + 2}", f"downs_{i}_attn", fa[i])
        if i >= n_stages - 1:
            m.conv(f"downs.{i}.{off + 3}", f"downs_{i}_downsample")
        else:
            m.conv(f"downs.{i}.{off + 3}.conv", f"downs_{i}_downsample/conv", dense=True)
    m.resnet("mid_block1", "mid_block1")
    if attn_enabled:
        m.full_attn("mid_attn", "mid_attn")
    m.resnet("mid_block2", "mid_block2")
    fa_r = fa[::-1]
    for i in range(n_stages):
        off = 0 if variant == "v1" else fuse_modules(f"ups.{i}", f"ups_{i}")
        m.resnet(f"ups.{i}.{off}", f"ups_{i}_block1")
        m.resnet(f"ups.{i}.{off + 1}", f"ups_{i}_block2")
        if attn_enabled:
            m.attn(f"ups.{i}.{off + 2}", f"ups_{i}_attn", fa_r[i])
        if i == n_stages - 1:
            m.conv(f"ups.{i}.{off + 3}", f"ups_{i}_upsample")
        else:
            m.conv(f"ups.{i}.{off + 3}.conv", f"ups_{i}_upsample/conv")
    m.resnet("final_res_block", "final_res_block")
    m.conv("final_conv", "final_conv", dense=True)
    return _finish(m, return_constants)


# the hyper-parameters that decide the mapping, as the JAX converter reads them
LIGHTNING_MODEL_KEYS = ("time_sin_pos", "time_learned_emb", "full_attn", "attn_enabled")


def load_lightning_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.ckpt`` as ``{"state_dict", "hparams", "ema_shadow"}``: the
    Lightning module's state dict (``net.*`` and ``embedding.weight``), its
    flat hyper-parameters and the EMA shadow kept at the checkpoint's root.
    The file is unpickled (``weights_only=False``, as the JAX package reads
    it), so it must be one the user trusts."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {
        "state_dict": ckpt.get("state_dict", ckpt),
        "hparams": dict(ckpt.get("hyper_parameters", {})),
        "ema_shadow": ckpt.get("ema_shadow", {}),
    }


def convert_lightning_module(ckpt: Mapping[str, Any], *, conditional: bool = False,
                             use_ema: bool = False) -> Dict[str, Any]:
    """``{"params", "constants", "embedding"}`` of a reference checkpoint (read
    by :func:`load_lightning_checkpoint`): the flax params, the frozen
    RandomFourier features (empty unless it was trained with
    ``time_learned_emb=False``) and the ``[n_cats, E]`` embedding table. With
    ``use_ema`` the persisted EMA shadow replaces the weights it covers."""
    sd = dict(ckpt["state_dict"])
    if use_ema and ckpt.get("ema_shadow"):
        for k, v in ckpt["ema_shadow"].items():
            key = k if k.startswith("net.") else f"net.{k}"
            if key in sd:
                sd[key] = v
    hp = ckpt["hparams"]
    mp = {k: hp[k] for k in LIGHTNING_MODEL_KEYS if k in hp}
    convert = convert_unet3d_cond if conditional else convert_unet3d
    params, constants = convert(
        sd,
        n_stages=len(hp.get("dim_mults", (1, 1, 2, 3, 4))),
        full_attn=mp.get("full_attn"),
        attn_enabled=mp.get("attn_enabled", True),
        time_sin_pos=mp.get("time_sin_pos", False),
        time_learned_emb=mp.get("time_learned_emb", True),
        src_prefix="net.",
        return_constants=True,
    )
    return {"params": params, "constants": constants, "embedding": _np(sd["embedding.weight"])}


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
    return params_from_jax({"params": _cast_floats(params, _as_float32),
                            "constants": _cast_floats(tree.get("constants") or {}, _as_float32)},
                           model)
