"""Writes checkpoints in the reference's Lightning file layout (test tooling).

The reference trains a Lightning module that holds ``self.net`` (the UNet)
and a frozen ``self.embedding``, and its ``.ckpt`` files hold:

- ``state_dict`` with ``net.*`` and ``embedding.weight`` keys, in torch
  layouts (conv kernels ``[out, in, k, k, k]``, 1×1 convs ``[out, in, 1, 1,
  1]``, Linear ``[out, in]``, RMSNorm gains ``[1, C, 1, 1, 1]``, the linear
  attention's memory KV ``[2, h, d, n]``);
- ``hyper_parameters``, flat (Lightning expands the module's model options
  into top-level entries);
- ``ema_shadow`` at the root, keyed by ``net.``-prefixed parameter names.

:func:`write_checkpoint` builds such a file from flax-layout trees (the
port's :func:`models.persistence.variables_to_jax` of a seeded model), under
the keys that the converter's ``_Mapper`` reads: the mirror image of
``convert_unet3d`` / ``convert_unet3d_cond``; with ``ndim=2`` the state dict is
the reference ``Unet2D``'s (kernels ``[out, in, k, k]``, gains ``[1, C, 1, 1]``,
each resample a Sequential whose module 1 holds the weights). Only torch and numpy are used,
so ``chip_smoke.py`` loads this file by its path.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


class _Writer:
    """Collects ``{reference key: tensor}`` from flax ``params`` and
    ``constants`` trees; ``trainable`` names the keys the EMA shadow covers."""

    def __init__(self, params: Mapping[str, Any], constants: Mapping[str, Any],
                 conditional: bool, ndim: int = 3):
        self.params, self.constants = params, constants
        self.conditional = conditional
        self.ndim = ndim
        self.sd: Dict[str, torch.Tensor] = {}
        self.trainable = set()

    def _leaf(self, dst: str, tree=None):
        node = self.params if tree is None else tree
        for part in dst.split("/"):
            node = node[part]
        return node

    def _has(self, dst: str) -> bool:
        try:
            self._leaf(dst)
            return True
        except KeyError:
            return False

    def put(self, key: str, value, trainable: bool = True) -> None:
        self.sd[f"net.{key}"] = _t(value)
        if trainable:
            self.trainable.add(f"net.{key}")

    def conv(self, src: str, dst: str, *, dense: bool = False) -> None:
        k = np.asarray(self._leaf(f"{dst}/kernel"))
        if dense:  # flax Dense [in, out] -> 1×1 conv [out, in, 1, 1(, 1)]
            w = k.T.reshape(k.shape[1], k.shape[0], *(1,) * self.ndim)
        else:      # flax [k, k(, k), in, out] -> [out, in, k, k(, k)]
            w = np.transpose(k, (k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))
        self.put(f"{src}.weight", w)
        if self._has(f"{dst}/bias"):
            self.put(f"{src}.bias", self._leaf(f"{dst}/bias"))

    def linear(self, src: str, dst: str) -> None:
        self.put(f"{src}.weight", np.asarray(self._leaf(f"{dst}/kernel")).T)
        if self._has(f"{dst}/bias"):
            self.put(f"{src}.bias", self._leaf(f"{dst}/bias"))

    def rmsnorm(self, src: str, dst: str) -> None:
        g = np.asarray(self._leaf(f"{dst}/g"))
        self.put(f"{src}.g", g.reshape(1, -1, *(1,) * self.ndim))

    def resnet(self, src: str, dst: str) -> None:
        mlp = "time_mlp" if self.conditional else "mlp"
        self.linear(f"{src}.{mlp}.1", f"{dst}/mlp")
        self.conv(f"{src}.block1.proj", f"{dst}/block1/proj")
        self.rmsnorm(f"{src}.block1.norm", f"{dst}/block1/norm")
        self.conv(f"{src}.block2.proj", f"{dst}/block2/proj")
        self.rmsnorm(f"{src}.block2.norm", f"{dst}/block2/norm")
        if self._has(f"{dst}/res_conv/kernel"):
            self.conv(f"{src}.res_conv", f"{dst}/res_conv", dense=True)

    def attn(self, src: str, dst: str, full: bool) -> None:
        self.rmsnorm(f"{src}.norm", f"{dst}/norm")
        mem = np.asarray(self._leaf(f"{dst}/mem_kv"))
        self.conv(f"{src}.to_qkv", f"{dst}/to_qkv", dense=True)
        if full:
            self.put(f"{src}.mem_kv", mem)
            self.conv(f"{src}.to_out", f"{dst}/to_out", dense=True)
        else:  # [2, h, n, d] -> the reference's [2, h, d, n]
            self.put(f"{src}.mem_kv", np.transpose(mem, (0, 1, 3, 2)))
            self.conv(f"{src}.to_out.0", f"{dst}/to_out", dense=True)
            self.rmsnorm(f"{src}.to_out.1", f"{dst}/out_norm")

    def time_mlp(self, sin_pos: bool, learned: bool) -> None:
        if not sin_pos:
            tree = self.params if learned else self.constants
            for name in ("freqs", "phases"):
                self.put(f"time_mlp.0.{name}", self._leaf(f"time_mlp/embed/{name}", tree),
                         trainable=learned)
        self.linear("time_mlp.1", "time_mlp/fc1")
        self.linear("time_mlp.3", "time_mlp/fc2")

    def fuse(self, src: str, dst: str) -> int:
        """A v3 stage's EmbedATb and MixATb; the index of its first ResnetBlock."""
        self.conv(f"{src}.0.conv1", f"{dst}_atb_embed/conv1")
        self.conv(f"{src}.0.conv2", f"{dst}_atb_embed/conv2")
        self.linear(f"{src}.1.time_mlp.1", f"{dst}_atb_mix/time_mlp")
        self.conv(f"{src}.1.conv1", f"{dst}_atb_mix/conv1")
        self.rmsnorm(f"{src}.1.norm", f"{dst}_atb_mix/norm")
        self.conv(f"{src}.1.conv2", f"{dst}_atb_mix/conv2")
        return 2


def reference_state_dict(params: Mapping[str, Any], constants: Optional[Mapping[str, Any]],
                         *, conditional: bool, n_stages: int,
                         full_attn: Optional[Sequence[bool]] = None, attn_enabled: bool = True,
                         time_sin_pos: bool = False, time_learned_emb: bool = True,
                         ndim: int = 3):
    """``(state_dict, trainable keys)`` of the reference UNet (``Unet3D``,
    ``Unet2D`` with ``ndim=2``, or ``Unet3DCond`` v3 with ``conditional``)
    holding the flax trees' values."""
    w = _Writer(params, constants or {}, conditional, ndim)
    fa = tuple(full_attn) if full_attn else (False,) * (n_stages - 1) + (True,)
    resample = "conv" if ndim == 3 else "1"
    if conditional:
        w.conv("init_conv_ATb", "init_conv_ATb")
        w.conv("init_conv_x", "init_conv_x")
    else:
        w.conv("init_conv", "init_conv")
    w.time_mlp(time_sin_pos, time_learned_emb)
    for i in range(n_stages):
        off = w.fuse(f"downs.{i}", f"downs_{i}") if conditional else 0
        w.resnet(f"downs.{i}.{off}", f"downs_{i}_block1")
        w.resnet(f"downs.{i}.{off + 1}", f"downs_{i}_block2")
        if attn_enabled:
            w.attn(f"downs.{i}.{off + 2}", f"downs_{i}_attn", fa[i])
        if i == n_stages - 1:
            w.conv(f"downs.{i}.{off + 3}", f"downs_{i}_downsample")
        else:
            w.conv(f"downs.{i}.{off + 3}.{resample}", f"downs_{i}_downsample/conv", dense=True)
    w.resnet("mid_block1", "mid_block1")
    if attn_enabled:
        w.attn("mid_attn", "mid_attn", True)
    w.resnet("mid_block2", "mid_block2")
    for i, full in enumerate(fa[::-1]):
        off = w.fuse(f"ups.{i}", f"ups_{i}") if conditional else 0
        w.resnet(f"ups.{i}.{off}", f"ups_{i}_block1")
        w.resnet(f"ups.{i}.{off + 1}", f"ups_{i}_block2")
        if attn_enabled:
            w.attn(f"ups.{i}.{off + 2}", f"ups_{i}_attn", full)
        if i == n_stages - 1:
            w.conv(f"ups.{i}.{off + 3}", f"ups_{i}_upsample")
        else:
            w.conv(f"ups.{i}.{off + 3}.{resample}", f"ups_{i}_upsample/conv")
    w.resnet("final_res_block", "final_res_block")
    w.conv("final_conv", "final_conv", dense=True)
    return w.sd, w.trainable


def write_checkpoint(path: str, variables: Mapping[str, Any], embedding: np.ndarray,
                     hyper_parameters: Mapping[str, Any], *, conditional: bool = False,
                     ema_params: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Write a reference-layout ``.ckpt`` of the flax ``variables`` (``params``
    and ``constants``) and the ``[n_cats, E]`` ``embedding`` to ``path``, with
    ``hyper_parameters`` flat and, given ``ema_params`` (a flax params tree),
    an ``ema_shadow`` of those values over the trainable ``net.*`` keys.
    Returns the checkpoint dict."""
    hp = dict(hyper_parameters)
    options = dict(conditional=conditional,
                   n_stages=len(hp.get("dim_mults", (1, 1, 2, 3, 4))),
                   full_attn=hp.get("full_attn"), attn_enabled=hp.get("attn_enabled", True),
                   time_sin_pos=hp.get("time_sin_pos", False),
                   time_learned_emb=hp.get("time_learned_emb", True))
    sd, trainable = reference_state_dict(variables["params"], variables.get("constants"),
                                         **options)
    sd["embedding.weight"] = _t(embedding)
    ckpt = {"state_dict": sd, "hyper_parameters": hp, "epoch": 0, "global_step": 0}
    if ema_params is not None:
        shadow, _ = reference_state_dict(ema_params, variables.get("constants"), **options)
        ckpt["ema_shadow"] = {k: v for k, v in shadow.items() if k in trainable}
    torch.save(ckpt, path)
    return ckpt
