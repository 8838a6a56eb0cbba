"""The port's v1 linear attention against the JAX package's v1 Pallas path.

The JAX side runs ``linear_attention`` (K4a ``_context_kernel`` and K4b
``_project_kernel``, with its closed-form ``_bwd``) under
``pltpu.force_tpu_interpret_mode()`` with ``block_n=128``, as
``tests/test_linear_attention.py`` does, so its online softmax runs over
several blocks with a ragged tail. The port's side is the wrappers on CPU
tensors, which run the plain PyTorch versions of its CUDA kernels, and its
closed-form backward. Inputs are drawn with numpy from a seed and handed to
both. Both compute every product in f32, so they differ only in the order of
the sums and in the softmax shift (a running max per block against the
global max): f32 outputs within atol 1e-5 and rtol 1e-4, bf16 outputs within
one bf16 ulp plus 1e-3·RMS, gradients within 1e-4 in relative L2.

The module test holds ``LinearAttention(fused=True, fused_folded=False)``
against the flax module built with ``fused=True`` at 32³ = 32,768 tokens, the
v1 dispatch threshold, on the same weights (``params_from_jax``), f32, at
atol/rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.models import attention as port_attention
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_tpu.models import attention as jax_attention
from flowtrain_stochastic_interpolation_tpu.ops import linear_attention as jax_la

HEADS, D = 2, 32


def _inputs(seed, n, m, batch=2, heads=HEADS, d=D):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return draw(batch, n, heads, d), draw(batch, m, heads, d), draw(batch, m, heads, d)


def _jax(arrays, dtype):
    with pltpu.force_tpu_interpret_mode():
        out = jax_la.linear_attention(*(jnp.asarray(a, dtype) for a in arrays), block_n=128)
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, dtype):
    return la.linear_attention(*(torch.from_numpy(a).to(dtype) for a in arrays))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(256, 260), (300, 304), (512, 512)])
def test_v1_matches_jax_pallas_interpret(n, m, dtype):
    arrays = _inputs(n + m, n, m)
    out = _port(arrays, getattr(torch, dtype))
    ref = _jax(arrays, getattr(jnp, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape == (2, n, HEADS, D)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    else:
        rms = np.sqrt(np.mean(ref**2))
        ulp = np.abs(ref) * 2.0**-7  # one bf16 ulp is at most 2^-7 of the value
        assert np.all(np.abs(out - ref) <= ulp + 1e-3 * rms), np.abs(out - ref).max()


@pytest.mark.parametrize("n,m,d", [(128, 132, 16), (300, 304, 32)])
def test_v1_gradients_match_jax_grad_of_the_interpret_kernel(n, m, d):
    arrays = _inputs(n, n, m, batch=1, d=d)
    cot = np.random.default_rng(n + 1).standard_normal((1, n, HEADS, d)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_la.linear_attention(q, k, v, block_n=128) * cot)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    la.linear_attention(*tensors).backward(torch.from_numpy(cot))
    for got, ref in zip(tensors, want):
        ref = np.asarray(ref)
        assert np.linalg.norm(got.grad.numpy() - ref) <= 1e-4 * np.linalg.norm(ref)


def test_reference_matches_jax_reference():
    arrays = _inputs(5, 200, 204)
    out = la.linear_attention_reference(*(torch.from_numpy(a) for a in arrays)).numpy()
    ref = np.asarray(jax_la.linear_attention_reference(*(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(9, 64, 68))
    la.reset_launch_counts()
    ctx = la.linear_context(k, v)
    out = la.linear_project(q, ctx)
    assert la.launch_counts == {"folded_context": 0, "folded_project": 0,
                                "linear_context": 0, "linear_project": 0}
    assert ctx.dtype == torch.float32 and ctx.shape == (2, HEADS, D, D)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(ctx, la.linear_context_plain(k, v), rtol=0, atol=0)
    torch.testing.assert_close(out, la.linear_project_plain(q, ctx), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------
def _random_tree(module, x, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
        if name == "g":
            return 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        return 0.5 * rng.standard_normal(leaf.shape)  # bias, mem_kv

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def recorded(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, recorded)


def test_linear_attention_module_v1_matches_flax_fused_at_32_cubed(monkeypatch):
    dim, heads, dim_head = 8, 2, 8
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 32, dim)).astype(np.float32)
    module = jax_attention.LinearAttention(dim=dim, heads=heads, dim_head=dim_head, fused=True)
    variables = _random_tree(module, jnp.asarray(x), 1)
    jax_calls, port_calls = [], []
    _spy(monkeypatch, jax_la, "linear_attention", jax_calls)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(module.apply(variables, jnp.asarray(x)))
    assert jax_calls == ["linear_attention"]  # the flax module took the v1 kernels

    port = port_attention.LinearAttention(dim, heads, dim_head, fused=True, fused_folded=False,
                                          device="cpu")
    port.load_state_dict(params_from_jax(variables, port))
    _spy(monkeypatch, port_attention, "linear_attention", port_calls)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert port_calls == ["linear_attention"] and port.takes_v1(32 ** 3)
    assert out.shape == ref.shape == (1, 32, 32, 32, dim)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_dispatch_checks_folded_before_v1(monkeypatch):
    """With ``fused`` and ``fused_folded`` both set, the folded rule is tried
    first, as in the JAX module. CPU tensors never take the folded kernels, so
    they go to v1, as JAX does on a backend that is not a TPU; where the folded
    rule holds, the folded path is taken and v1 is not."""
    calls = []
    _spy(monkeypatch, port_attention, "linear_attention", calls)
    _spy(monkeypatch, port_attention, "linear_attention_folded", calls)
    gen = torch.Generator().manual_seed(0)
    attn = port_attention.LinearAttention(8, heads=4, dim_head=32, fused=True, device="cpu")
    for m in attn.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x = torch.randn(1, 32, 32, 32, 8, generator=gen)
    with torch.no_grad():
        attn(x)
        assert calls == ["linear_attention"]
        monkeypatch.setattr(attn, "takes_folded", lambda qkv: True)
        attn(x)
        assert calls == ["linear_attention", "linear_attention_folded"]
        attn.fused = False
        monkeypatch.setattr(attn, "takes_folded", lambda qkv: False)
        attn(x)  # neither: the einsum form
    assert calls == ["linear_attention", "linear_attention_folded"]
    assert not attn.takes_v1(32 ** 3) and not port_attention.LinearAttention(
        8, fused=True, device="cpu").takes_v1(32 ** 3 - 1)
