"""The collectives of the port's parallelism, and their transposes.

The JAX package's ``lax.ppermute``, ``lax.psum`` and ``lax.pmax`` are
differentiable inside ``shard_map``; here each is a ``torch.autograd.Function``
over ``torch.distributed``, with JAX's transpose as its backward:

* :func:`ppermute` ``(x, shift, group)``: rank i of the group receives rank
  ``i - shift``'s x (a ring); its backward sends the cotangent back,
  ``ppermute(g, -shift)``;
* :func:`all_reduce_sum`: the sum over the group; its backward is the sum of
  the cotangents over the group;
* :func:`all_reduce_max`: the maximum over the group, detached (JAX
  stop-gradients ``pmax``'s operand).

A group of None is a group of one rank: every collective is then the
identity (a copy for :func:`ppermute`).

Every rank must issue the same collectives in the same order, in the forward
and in the backward. Autograd runs each backward on the device thread of its
forward and orders the nodes of one graph by their sequence numbers, which
are the same on every rank that runs the same code; a collective's output
must therefore always reach the loss, on every rank (multiply it by zero,
never drop it, where a rank has no use for it).

Transport: NCCL takes CUDA tensors; gloo takes CPU tensors, and CUDA tensors
in some collectives but not in others. :func:`stages` decides, from the
backend and the device alone, whether a tensor goes through pinned host
memory; the compute stays on the tensor's device either way. :data:`traffic`
counts the bytes that each kind of collective moved (one rank's payload).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

traffic: Dict[str, int] = {"ppermute": 0, "all_reduce": 0}


def reset_traffic() -> None:
    for k in traffic:
        traffic[k] = 0


def stages(backend: str, device: torch.device) -> bool:
    """Whether a collective of ``backend`` on a tensor on ``device`` copies it
    through pinned host memory: only gloo with a CUDA tensor does. NCCL on a
    CPU tensor, or an unknown backend, raises."""
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL takes CUDA tensors only, got one on {device}")
        return False
    if backend == "gloo":
        return device.type == "cuda"
    raise ValueError(f"unsupported backend {backend!r}")


def _size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer of x's shape and dtype (the caching host allocator's)."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _transported(x: torch.Tensor, group, run: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """``run`` (an in-place collective) on a contiguous copy of x, through pinned
    host memory where :func:`stages` says so; the result on x's device."""
    if stages(dist.get_backend(group), x.device):
        host = _pinned(x).copy_(x)
        run(host)
        return host.to(x.device)
    buf = x.contiguous().clone()
    run(buf)
    return buf


def _ppermute(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    stage = stages(dist.get_backend(group), x.device)
    send = _pinned(x).copy_(x) if stage else x.contiguous()
    recv = _pinned(x) if stage else torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    traffic["ppermute"] += send.numel() * send.element_size()
    return recv.to(x.device) if stage else recv


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if _size(group) == 1:
        return x.clone()
    traffic["all_reduce"] += x.numel() * x.element_size()
    return _transported(x, group, lambda t: dist.all_reduce(t, op=op, group=group))


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _ppermute(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, -ctx.shift, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group, dist.ReduceOp.SUM), None


def ppermute(x: torch.Tensor, shift: int, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Rank i of ``group`` gets rank ``(i - shift) mod n``'s x; differentiable."""
    return _PPermute.apply(x, shift, group)


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of x over ``group``, on every rank; differentiable."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The maximum of x over ``group``, on every rank; detached."""
    return _reduce(x.detach(), group, dist.ReduceOp.MAX)


def broadcast(x: torch.Tensor, src: int, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Global rank ``src``'s x on every rank of ``group``; detached."""
    if _size(group) == 1:
        return x.detach().clone()
    return _transported(x.detach(), group, lambda t: dist.broadcast(t, src, group=group))
