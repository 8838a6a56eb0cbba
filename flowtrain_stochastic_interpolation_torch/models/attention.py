"""Attention blocks over flattened voxel tokens, channels-last in and out.

Port of ``flowtrain_stochastic_interpolation_tpu/models/attention.py``:

* :class:`LinearAttention` — softmax-q / softmax-k linear attention with 4
  memory KV tokens, at every UNet stage but the innermost. It dispatches in
  the JAX module's order: on CUDA, with ``fused_folded`` (the default), at
  least 4096 tokens and a folded width ``h·d`` that is a multiple of 128, the
  folded kernels K1 and K2 (:mod:`ops.linear_attention`) on the ``[B, N,
  h·d]`` projection in place; else, with ``fused`` set, at least 32,768
  tokens and a head width that is a multiple of 8, the v1 kernels K4a and K4b
  (:func:`ops.linear_attention.linear_attention`) on the concatenated memory
  KV; otherwise the einsum form. On CPU tensors the kernels' wrappers run
  their plain versions. The kernels take bf16 or f32 and every head width
  that is a multiple of 8.
* :class:`Attention` — full softmax attention with memory KV. With ``flash``
  on, at least 1024 query tokens and a head width that is a multiple of 8, it
  runs :func:`ops.flash_attention.flash_attention` (kernel K3 on the card, its
  plain f32 version on the CPU), as the JAX package's ``_sdpa`` dispatches;
  otherwise (and on the ``meta`` device, which only counts) einsum + softmax
  (the flagship's innermost stage has 4³ = 64 tokens, so it stays einsum).

With a ``spatial_group`` (the JAX modules' ``spatial_axis``: the token axis
sharded over the group, X slab by X slab), both take their sharded form
before any other: :func:`parallel.spatial.sharded_linear_attention` and
:func:`parallel.spatial.ring_attention`, in f32 and with no hand-written
kernel, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.models.layers import Dense, RMSNorm
from flowtrain_stochastic_interpolation_torch.ops.flash_attention import flash_attention
from flowtrain_stochastic_interpolation_torch.ops.linear_attention import (
    linear_attention,
    linear_attention_folded,
)
from flowtrain_stochastic_interpolation_torch.parallel.spatial import (
    ring_attention,
    sharded_linear_attention,
)

_FOLDED_LINEAR_MIN_TOKENS = 4096
_FUSED_LINEAR_MIN_TOKENS = 32768
_FLASH_MIN_TOKENS = 1024


def _memory_kv(mem_kv: torch.Tensor, b: int, dtype: torch.dtype):
    """``[2, h, n_mem, d]`` parameter -> keys and values ``[B, n_mem, h, d]``."""
    mem = mem_kv.to(dtype)
    expand = lambda t: t.transpose(0, 1).unsqueeze(0).expand(b, -1, -1, -1)
    return expand(mem[0]), expand(mem[1])


class _TokenAttention(nn.Module):
    """Shared parameters: input RMSNorm, bias-free qkv projection, memory KV."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_mem_kv: int = 4,
                 *, spatial_group=None, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.heads, self.dim_head, self.num_mem_kv = heads, dim_head, num_mem_kv
        self.spatial_group = spatial_group
        hidden = heads * dim_head
        self.norm = RMSNorm(dim, device=device)
        self.to_qkv = Dense(dim, hidden * 3, use_bias=False, dtype=dtype, device=device)
        self.mem_kv = nn.Parameter(torch.empty(2, heads, num_mem_kv, dim_head, device=device))
        self.to_out = Dense(hidden, dim, dtype=dtype, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.mem_kv.normal_(0.0, 1.0, generator=generator)

    def _split(self, qkv: torch.Tensor):
        """``[B, N, 3·h·d]`` projection -> q, k, v ``[B, N, h, d]`` (slices of it)
        and the memory keys and values ``[B, n_mem, h, d]``."""
        b, n = qkv.shape[:2]
        qkv = qkv.reshape(b, n, 3, self.heads, self.dim_head)
        return (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                *_memory_kv(self.mem_kv, b, qkv.dtype))

    def _split_with_memory(self, qkv: torch.Tensor):
        """``[B, N, 3·h·d]`` projection -> q ``[B, N, h, d]`` (a slice of it) and
        k, v ``[B, n_mem + N, h, d]`` with the memory tokens first."""
        q, k, v, mk, mv = self._split(qkv)
        return q, torch.cat([mk, k], dim=1), torch.cat([mv, v], dim=1)


class LinearAttention(_TokenAttention):
    """O(N) linear attention: q softmaxed over each head's features, k over tokens."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_mem_kv: int = 4,
                 *, fused: bool = False, fused_folded: bool = True,
                 folded_vjp: Optional[str] = None, spatial_group=None,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(dim, heads, dim_head, num_mem_kv, spatial_group=spatial_group,
                         dtype=dtype, device=device)
        self.fused = fused
        self.fused_folded = fused_folded
        self.folded_vjp = folded_vjp
        self.out_norm = RMSNorm(dim, device=device)

    def takes_folded(self, qkv: torch.Tensor) -> bool:
        """The folded-kernel dispatch rule, for a ``[B, N, 3·h·d]`` projection."""
        hidden = self.heads * self.dim_head
        return (
            self.fused_folded
            and self.spatial_group is None
            and qkv.is_cuda
            and qkv.shape[1] >= _FOLDED_LINEAR_MIN_TOKENS
            and hidden % 128 == 0
        )

    def takes_v1(self, n: int) -> bool:
        """The v1-kernel dispatch rule, for ``n`` tokens (checked after the folded one)."""
        return self.fused and n >= _FUSED_LINEAR_MIN_TOKENS and self.dim_head % 8 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, spatial = x.shape[0], x.shape[1:-1]
        hidden = self.heads * self.dim_head
        qkv = self.to_qkv(self.norm(x)).reshape(b, -1, 3 * hidden)
        if self.spatial_group is not None:
            q, k, v, mk, mv = self._split(qkv)
            out = sharded_linear_attention(q, k, v, self.spatial_group, mem_k=mk, mem_v=mv)
        elif self.takes_folded(qkv):
            out = self.attend_folded(qkv)
        elif self.takes_v1(qkv.shape[1]):
            out = self.attend_v1(qkv)
        else:
            out = self.attend_einsum(qkv)
        out = self.to_out(out.reshape(b, *spatial, hidden))
        return self.out_norm(out)

    def attend_folded(self, qkv: torch.Tensor) -> torch.Tensor:
        """K1 + K2 on the column slices of the projection: ``[B, N, h·d]``."""
        hidden = self.heads * self.dim_head
        q, k, v = qkv[..., :hidden], qkv[..., hidden:2 * hidden], qkv[..., 2 * hidden:]
        mem = self.mem_kv.to(qkv.dtype)
        # [h, n_mem, d] -> [n_mem, h·d], the folded layout
        fold = lambda t: t.transpose(0, 1).reshape(self.num_mem_kv, hidden).contiguous()
        return linear_attention_folded(q, k, v, fold(mem[0]), fold(mem[1]), heads=self.heads,
                                       backward=self.folded_vjp)

    def attend_v1(self, qkv: torch.Tensor) -> torch.Tensor:
        """K4a + K4b on q in place and the concatenated k, v: ``[B, N, h, d]``."""
        return linear_attention(*self._split_with_memory(qkv))

    def attend_einsum(self, qkv: torch.Tensor) -> torch.Tensor:
        """The einsum form with concatenated memory KV: ``[B, N, h, d]``."""
        q, k, v = self._split_with_memory(qkv)
        q = torch.softmax(q, dim=-1) * self.dim_head**-0.5
        k = torch.softmax(k, dim=1)
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        return torch.einsum("bhde,bnhd->bnhe", context, q)


class Attention(_TokenAttention):
    """Full softmax attention with memory KV: flash at ≥ 1024 tokens, else einsum."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_mem_kv: int = 4,
                 *, flash: bool = True, spatial_group=None, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(dim, heads, dim_head, num_mem_kv, spatial_group=spatial_group,
                         dtype=dtype, device=device)
        self.flash = flash

    def takes_flash(self, n: int) -> bool:
        """The flash dispatch rule of ``_sdpa``, for ``n`` query tokens."""
        return self.flash and n >= _FLASH_MIN_TOKENS and self.dim_head % 8 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, spatial = x.shape[0], x.shape[1:-1]
        hidden = self.heads * self.dim_head
        qkv = self.to_qkv(self.norm(x)).reshape(b, -1, 3 * hidden)
        if self.spatial_group is not None:
            q, k, v, mk, mv = self._split(qkv)
            out = ring_attention(q, k, v, self.spatial_group, mem_k=mk, mem_v=mv)
            return self.to_out(out.reshape(b, *spatial, hidden))
        q, k, v = self._split_with_memory(qkv)
        # on meta (a FLOP count, utils.flops) the einsum route: the same products
        if self.takes_flash(q.shape[1]) and not q.is_meta:
            out = flash_attention(q, k, v)
        else:
            logits = torch.einsum("bihd,bjhd->bhij", q, k) * self.dim_head**-0.5
            probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            out = torch.einsum("bhij,bjhd->bihd", probs, v)
        return self.to_out(out.reshape(b, *spatial, hidden))
