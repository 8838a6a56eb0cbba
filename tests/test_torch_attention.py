"""The port's attention modules against the flax modules on the same weights (CPU, f32).

``LinearAttention`` runs at 16³ = 4096 tokens with hidden 128 (4 heads x 32)
on dim 16, the shape at which the folded-kernel dispatch rule is met on the
card; ``Attention`` at 4³. The JAX CPU path is the einsum form, which equals
the folded form (``tests/test_linear_attention.py``). Weights are drawn with
numpy in the shapes of the flax ``init`` tree and mapped by
``params_from_jax``; f32 on both sides, rtol/atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.models import attention as port_attention
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_tpu.models import attention as jax_attention

torch.backends.cuda.matmul.allow_tf32 = False

DIM, HEADS, DIM_HEAD = 16, 4, 32


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


def _pair(jax_cls, port_cls, side, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, side, side, side, DIM)).astype(np.float32)
    module = jax_cls(dim=DIM, heads=HEADS, dim_head=DIM_HEAD)
    variables = _random_tree(module, jnp.asarray(x), seed)
    ref = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))
    port = port_cls(DIM, HEADS, DIM_HEAD, device="cpu")
    port.load_state_dict(params_from_jax(variables, port))
    return port, torch.from_numpy(x), ref


def test_linear_attention_matches_flax_at_4096_tokens():
    port, x, ref = _pair(jax_attention.LinearAttention, port_attention.LinearAttention, 16, 0)
    qkv = port.to_qkv(port.norm(x)).reshape(2, -1, 3 * HEADS * DIM_HEAD)
    assert qkv.shape[1] == 4096
    assert not port.takes_folded(qkv)  # CPU tensors take the einsum form
    with torch.no_grad():
        out = port(x).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 16, DIM)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_linear_attention_folded_form_matches_flax(monkeypatch):
    """The folded form (K1 + K2's plain versions on the module's own qkv
    slices) at the folded kernels' tolerance: they round p, v and ctx to bf16."""
    port, x, ref = _pair(jax_attention.LinearAttention, port_attention.LinearAttention, 16, 1)
    monkeypatch.setattr(port, "takes_folded", lambda qkv: True)
    with torch.no_grad():
        out = port(x).numpy()
    np.testing.assert_allclose(out, ref, rtol=3e-2, atol=3e-3)


def test_full_attention_matches_flax_at_4_cubed():
    port, x, ref = _pair(jax_attention.Attention, port_attention.Attention, 4, 2)
    with torch.no_grad():
        out = port(x).numpy()
    assert out.shape == ref.shape == (2, 4, 4, 4, DIM)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
