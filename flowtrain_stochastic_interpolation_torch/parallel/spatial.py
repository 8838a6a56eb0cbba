"""Spatial (context) parallelism: the X axis of ``[B, X, Y, Z, C]`` over ranks.

Port of ``flowtrain_stochastic_interpolation_tpu/parallel/spatial.py``. Each
rank of a ``spatial`` group holds one slab of X, in rank order; the ops that
mix information across X become collectives over the group
(:mod:`parallel.collectives`, differentiable):

* :func:`halo_exchange`: neighbour slabs on both sides of X, zeros at the
  global edges; a halo wider than the slab reaches over as many ranks as it
  needs (the 5³ ATb towers of ``conditional_64`` at its 4³ stage over 4 ranks:
  X_loc = 1, halo 2), where the JAX function raises;
* :func:`halo_conv3d`: the SAME 3-D convolution (cuDNN ``F.conv3d``) of the
  halo-extended slab, VALID along X and SAME along Y and Z;
* :func:`sharded_resize3d`: the align-corners trilinear resize, X through the
  shard's block of the global interpolation matrix against a 1-halo (in f32),
  Y and Z locally;
* :func:`ring_attention`: exact softmax attention, K/V blocks passed around
  the ring, online max and sum in f32, the memory K/V entering once;
* :func:`sharded_linear_attention`: the softmax-q / softmax-k linear
  attention with the token softmax's max and sums over the group, in f32.

Each reproduces the unsharded op within f32 rounding (tests/test_torch_spatial.py).
None of them launches a hand-written kernel: JAX takes its Pallas path only
without a spatial axis, and so does the port.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.parallel.collectives import (
    all_reduce_max,
    all_reduce_sum,
    ppermute,
)


def _rank_and_size(group: Optional[dist.ProcessGroup]):
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def halo_exchange(x: torch.Tensor, group: Optional[dist.ProcessGroup], halo: int,
                  axis: int = 1) -> torch.Tensor:
    """x extended by ``halo`` entries on each side of ``axis``: the neighbours'
    boundary slabs, zeros at the global edges (SAME padding). A halo wider than
    the slab takes whole slabs from the nearer ranks and the rest from the next,
    one ppermute each way per rank it reaches over."""
    if halo == 0:
        return x
    idx, n = _rank_and_size(group)
    size = x.shape[axis]
    lefts, rights = [], []
    for hop in range(1, -(-halo // size) + 1):
        width = min(size, halo - (hop - 1) * size)
        # rank i gets rank i - hop's last `width` entries on its left and rank
        # i + hop's first on its right; every rank uses both received slabs (past
        # the edges times zero), so that every rank runs the same collectives in
        # the backward
        left = ppermute(x.narrow(axis, size - width, width), hop, group)
        right = ppermute(x.narrow(axis, 0, width), -hop, group)
        if idx - hop < 0:
            left = left * 0
        if idx + hop > n - 1:
            right = right * 0
        lefts.insert(0, left)
        rights.append(right)
    return torch.cat([*lefts, x, *rights], dim=axis)


def halo_conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """SAME convolution of ``[B, X_loc, Y, Z, C]`` with X sharded over ``group``;
    ``weight`` is torch's ``[out, in, kx, ky, kz]``. Output ``[B, X_loc, Y, Z, out]``."""
    kx, ky, kz = weight.shape[2:]
    x_ext = halo_exchange(x, group, kx // 2, axis=1)
    fmt = torch.channels_last_3d
    xc = x_ext.permute(0, 4, 1, 2, 3).contiguous(memory_format=fmt)
    y = F.conv3d(xc, weight.contiguous(memory_format=fmt), bias, padding=(0, ky // 2, kz // 2))
    return y.permute(0, 2, 3, 4, 1).contiguous()


@lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense ``[n_out, n_in]`` align-corners linear interpolation matrix (the JAX
    package's ``models/resize.py::_resize_matrix``)."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1:
        w[0, 0] = 1.0
        return w
    if n_in == 1:
        w[:, 0] = 1.0
        return w
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - lo
    rows = np.arange(n_out)
    w[rows, lo] = (1.0 - frac).astype(np.float32)
    w[rows, lo + 1] = frac.astype(np.float32)
    return w


@lru_cache(maxsize=None)
def _shard_resize_blocks(n_in: int, n_out: int, n_shards: int) -> np.ndarray:
    """Per-shard ``[out_loc, in_loc + 2]`` slices of the global align-corners
    matrix: column t reads global input ``shard * in_loc - 1 + t`` (a 1-halo
    extended slab). Raises unless a 1-halo covers every shard's support."""
    if n_in % n_shards or n_out % n_shards:
        raise ValueError(f"resize {n_in} -> {n_out} must divide over {n_shards} shards")
    in_loc, out_loc = n_in // n_shards, n_out // n_shards
    wp = np.zeros((n_out, n_in + 2), np.float32)
    wp[:, 1:-1] = _resize_matrix(n_in, n_out)
    blocks = np.zeros((n_shards, out_loc, in_loc + 2), np.float32)
    for j in range(n_shards):
        rows = slice(j * out_loc, (j + 1) * out_loc)
        cols = slice(j * in_loc, j * in_loc + in_loc + 2)
        blocks[j] = wp[rows, cols]
        outside = wp[rows].copy()
        outside[:, cols] = 0.0
        if outside.any():
            raise ValueError(f"shard {j}: resize {n_in} -> {n_out} reads past a 1-halo")
    return blocks


def sharded_resize3d(x: torch.Tensor, scale: float,
                     group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Align-corners trilinear resize of ``[B, X_loc, Y, Z, C]`` by ``scale``, X
    sharded over ``group``. X: the shard's block of the global matrix against
    the 1-halo slab, in f32; Y and Z: ``F.interpolate`` (bilinear, align
    corners) on the slab, as the unsharded :func:`models.resize.resize3d`."""
    idx, n = _rank_and_size(group)
    b, x_loc, y, z, c = x.shape
    n_in = x_loc * n
    n_out = int(np.floor(n_in * scale))
    block = torch.from_numpy(_shard_resize_blocks(n_in, n_out, n)[idx]).to(x.device)
    x_ext = halo_exchange(x, group, 1, axis=1)
    out = torch.einsum("oi,biyzc->boyzc", block, x_ext.float()).to(x.dtype)
    size = (int(np.floor(y * scale)), int(np.floor(z * scale)))
    if size == (y, z):
        return out
    o = out.shape[1]
    flat = out.reshape(b * o, y, z, c).permute(0, 3, 1, 2)
    flat = F.interpolate(flat, size=size, mode="bilinear", align_corners=True)
    return flat.permute(0, 2, 3, 1).reshape(b, o, *size, c).contiguous()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Optional[dist.ProcessGroup], *,
                   mem_k: Optional[torch.Tensor] = None, mem_v: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of the local queries over the keys of every rank.

    ``q, k, v``: ``[B, N_loc, H, D]``; ``mem_k, mem_v``: ``[B, M, H, D]``, attended
    once, before the ring. The K/V blocks travel the ring for n - 1 steps
    while the running max, sum and output build the exact softmax in f32.
    Returns ``[B, N_loc, H, D]`` in q's dtype.
    """
    _, n = _rank_and_size(group)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float() * scale

    def attend(m, l, o, kb, vb):
        logits = torch.einsum("bnhd,bmhd->bhnm", qf, kb.float())
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha.transpose(1, 2)[..., None] + torch.einsum("bhnm,bmhd->bnhd", p, vb.float())
        return m_new, l, o

    b, n_loc, h, d = q.shape
    m = torch.full((b, h, n_loc), -torch.inf, device=q.device)
    l = torch.zeros((b, h, n_loc), device=q.device)
    o = torch.zeros((b, n_loc, h, d), device=q.device)
    if mem_k is not None:
        m, l, o = attend(m, l, o, mem_k, mem_v)
    kb, vb = k, v
    for step in range(n):
        m, l, o = attend(m, l, o, kb, vb)
        if step < n - 1:
            kb, vb = ppermute(kb, 1, group), ppermute(vb, 1, group)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def sharded_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             group: Optional[dist.ProcessGroup], *,
                             mem_k: Optional[torch.Tensor] = None,
                             mem_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's linear attention with the token axis sharded.

    q is softmaxed over its features (local); k over the global token axis,
    with the per-feature max taken over the group (detached: a shift that the
    softmax does not see) and the denominator and context ``kᵀv`` summed over
    it, one all-reduce each, in f32. The memory tokens are active on rank 0
    only (-inf elsewhere), so that they enter the softmax once.
    ``[B, N_loc, H, D]`` in and out.
    """
    idx, _ = _rank_and_size(group)
    d = q.shape[-1]
    qf = torch.softmax(q.float(), dim=-1) * d**-0.5
    kf, vv = k.float(), v.float()
    if mem_k is not None:
        mk = mem_k.float()
        if idx != 0:
            mk = torch.full_like(mk, -torch.inf)
        kf = torch.cat([mk, kf], dim=1)
        vv = torch.cat([mem_v.float(), vv], dim=1)
    m = all_reduce_max(kf.detach().amax(dim=1), group)  # [B, H, D]
    p = torch.exp(kf - m[:, None])  # exp(-inf) = 0 for the masked memory tokens
    denom = all_reduce_sum(p.sum(dim=1), group)
    context = all_reduce_sum(torch.einsum("bnhd,bnhe->bhde", p, vv), group)
    context = context / denom[..., None]
    return torch.einsum("bhde,bnhd->bnhe", context, qf).to(q.dtype)
