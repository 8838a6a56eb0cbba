"""Rematerialisation: activation checkpoints that keep dropout's draws.

The JAX package's ``remat`` (``jax.checkpoint`` around the whole forward,
with a policy of what to save) and ``remat_blocks`` (around each ResnetBlock
and attention module) become ``torch.utils.checkpoint`` here, non-reentrant,
with :func:`torch.utils.checkpoint.create_selective_checkpoint_contexts` for
the policies:

* ``"nothing"`` saves nothing: the backward recomputes the whole region;
* ``"dots"`` (JAX's ``dots_with_no_batch_dims_saveable``) saves the outputs
  of the products without batch dims, the ``nn.Dense`` layers' ``aten.mm`` /
  ``aten.addmm`` (q, k, v, the FiLM and the time MLP), and no batched
  product and no convolution;
* with ``save_atb`` (JAX's ``save_only_these_names("atb_tower")``), also the
  conditioning towers' resized input and convolutions, the ops that run
  inside :func:`named_region` ``("atb_tower")``.

``torch.utils.checkpoint`` restores only the global CPU and CUDA random
states for the recompute, while the port's dropout draws from the
``torch.Generator`` passed to the forward. :func:`checkpoint` therefore saves
that generator's state before the region and replays it for the recompute
(then puts back the state the recompute found), so the recomputed masks are
the forward's.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint as _checkpoint,
    create_selective_checkpoint_contexts,
)

POLICIES = ("nothing", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_TOWER = (torch.ops.aten.convolution.default, torch.ops.aten.upsample_trilinear3d.default)

_regions = threading.local()


@contextlib.contextmanager
def named_region(name: str):
    """Mark the ops that run inside the block as ``name``'s, for a policy that
    saves them (JAX's ``checkpoint_name``)."""
    outer = getattr(_regions, "name", None)
    _regions.name = name
    try:
        yield
    finally:
        _regions.name = outer


def _policy(remat_policy: str, save_atb: bool):
    if remat_policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; options: {POLICIES}")
    dots = remat_policy == "dots"

    def policy(ctx, op, *args, **kwargs):
        if (dots and op in _DOTS) or (
                save_atb and op in _TOWER and getattr(_regions, "name", None) == "atb_tower"):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def checkpoint(fn: Callable, *args, generator: Optional[torch.Generator] = None,
               remat_policy: str = "nothing", save_atb: bool = False):
    """``fn(*args, generator)`` under a non-reentrant activation checkpoint whose
    recompute replays ``generator``'s draws. ``remat_policy`` and ``save_atb``
    say what the forward keeps (module docstring)."""
    state = generator.get_state() if generator is not None else None
    calls = []

    def run(*inner):
        if generator is None or not calls:  # the forward itself
            calls.append(True)
            return fn(*inner, generator)
        found = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*inner, generator)
        finally:
            generator.set_state(found)

    policy = _policy(remat_policy, save_atb)
    kwargs = {}
    if remat_policy != "nothing" or save_atb:  # else nothing is saved: the plain checkpoint
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, policy)
    return _checkpoint(run, *args, use_reentrant=False, **kwargs)
