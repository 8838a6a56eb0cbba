"""The port's folded linear-attention backward against the JAX package's.

``linear_attention_folded`` is a ``torch.autograd.Function`` whose backward is
the JAX package's closed form (``_folded_vjp_bwd_closed_form_bf16``, the
default, or ``_folded_vjp_bwd_closed_form``) in torch operations. The JAX side
is ``jax.vjp`` of ``linear_attention_folded(..., backward=...)``, its forward
under ``pltpu.force_tpu_interpret_mode()``. Inputs and the output cotangent are
drawn with numpy and handed to both, at b2 × (4096 + 37) tokens × 4 heads × 32.

Tolerances: with f32 streams both sides compute the same f32 math in another
order, so each gradient is within 1e-5 in relative L2; with bf16 streams both
round the same ``[N, h·d]`` intermediates to bf16, and each gradient is within
1e-2 in relative L2. Against autograd of an f32 einsum reference, each
gradient's largest error is within 2e-2 of its largest value, the bound the
JAX package holds its bf16 backward to (``tests/test_linear_attention.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_tpu.ops.linear_attention import (
    linear_attention_folded as jax_linear_attention_folded,
)

HEADS, D = 4, 32
HD = HEADS * D
N = 4096 + 37
NAMES = ("dq", "dk", "dv", "dmk", "dmv")


@functools.lru_cache(maxsize=None)
def _arrays(seed=0, batch=2, n=N):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    inputs = (draw(batch, n, HD), draw(batch, n, HD), draw(batch, n, HD), draw(4, HD), draw(4, HD))
    return inputs, draw(batch, n, HD)


@functools.lru_cache(maxsize=None)
def _jax_grads(backward, dtype_name):
    inputs, dout = _arrays()
    dtype = getattr(jnp, dtype_name)
    fn = functools.partial(jax_linear_attention_folded, heads=HEADS, backward=backward)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in inputs))
        grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(backward, dtype):
    inputs, dout = _arrays()
    tensors = [torch.from_numpy(a).to(dtype).requires_grad_() for a in inputs]
    out = la.linear_attention_folded(*tensors, heads=HEADS, backward=backward)
    out.backward(torch.from_numpy(dout).to(dtype))
    return [t.grad.float().numpy() for t in tensors]


def _reference_grads():
    """Autograd of the f32 einsum composition, on the bf16-rounded inputs."""
    inputs, dout = _arrays()
    q, k, v, mk, mv = [torch.from_numpy(a).to(torch.bfloat16).float().requires_grad_()
                       for a in inputs]
    b = q.shape[0]
    split = lambda t: t.reshape(t.shape[0], -1, HEADS, D)
    kk = torch.cat([mk.expand(b, -1, -1), k], dim=1)
    vv = torch.cat([mv.expand(b, -1, -1), v], dim=1)
    qs = torch.softmax(split(q), dim=-1) * D**-0.5
    ctx = torch.einsum("bnhd,bnhe->bhde", torch.softmax(split(kk), dim=1), split(vv))
    out = torch.einsum("bnhd,bhde->bnhe", qs, ctx).reshape(q.shape)
    out.backward(torch.from_numpy(dout).to(torch.bfloat16).float())
    return [t.grad.numpy() for t in (q, k, v, mk, mv)]


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("backward", ["closed_form_bf16", "closed_form"])
def test_f32_streams_match_jax(backward):
    got = _port_grads(backward, torch.float32)
    want = _jax_grads(backward, "float32")
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _rel_l2(g, w) <= 1e-5, (name, _rel_l2(g, w))


def test_bf16_streams_match_jax_closed_form_bf16():
    got = _port_grads("closed_form_bf16", torch.bfloat16)
    want = _jax_grads("closed_form_bf16", "bfloat16")
    for name, g, w in zip(NAMES, got, want):
        assert _rel_l2(g, w) <= 1e-2, (name, _rel_l2(g, w))


def test_bf16_backward_both_sides_near_the_f32_reference():
    ref = _reference_grads()
    for grads in (_port_grads("closed_form_bf16", torch.bfloat16),
                  _jax_grads("closed_form_bf16", "bfloat16")):
        for name, g, r in zip(NAMES, grads, ref):
            assert np.abs(g - r).max() / np.abs(r).max() < 2e-2, name


def test_default_backward_is_closed_form_bf16():
    inputs, dout = _arrays(seed=1, batch=1, n=300)
    grads = []
    for backward in (None, "closed_form_bf16"):
        tensors = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in inputs]
        la.linear_attention_folded(*tensors, heads=HEADS, backward=backward).backward(
            torch.from_numpy(dout).to(torch.bfloat16))
        grads.append([t.grad for t in tensors])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("backward", ["chunked", "autodiff"])
def test_unported_backwards_raise(backward):
    """Both are ported now (tests/test_torch_memory_forms.py holds them against
    JAX): their gradients through linear_attention_folded are the f32 closed
    form's, to f32 rounding."""
    inputs, dout = _arrays(seed=1, batch=1, n=300)
    grads = []
    for form in (backward, "closed_form"):
        tensors = [torch.from_numpy(a).requires_grad_() for a in inputs]
        out = la.linear_attention_folded(*tensors, heads=HEADS, backward=form)
        assert out.shape == (1, 300, HD)
        out.backward(torch.from_numpy(dout))
        grads.append([t.grad for t in tensors])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_backward_at_the_chunked_row_count_raises():
    """At 2^20 rows per item the closed forms hand over to the chunked one, as
    in JAX, instead of raising."""
    big = la.CHUNKED_BWD_MIN_ROWS
    assert la.backward_form(None, big) == la.backward_form("closed_form", big) == "chunked"
    assert la.backward_form(None, big - 1) == "closed_form_bf16"


def test_unknown_backward_is_a_value_error():
    q = torch.zeros(1, 8, HD)
    with pytest.raises(ValueError, match="unknown backward"):
        la.linear_attention_folded(q, q, q, torch.zeros(4, HD), torch.zeros(4, HD),
                                   heads=HEADS, backward="closed-form")
