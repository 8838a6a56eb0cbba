"""Which path each attention layer of the flagship takes, at 64³, 128³ and 256³,
in the port and in the JAX package.

The port's flagship (``unconditional_64``) runs on the ``meta`` device (no
memory); a pre-hook on every ``LinearAttention`` and ``Attention`` records its
token count, and the module's own dispatch rules say what it takes on a card:
the folded kernels K1 + K2 (``takes_folded`` of a CUDA projection), the v1
kernels K4a + K4b (``takes_v1``), flash K3 (``takes_flash``) or einsum. The
JAX flagship is traced on abstract shapes (``jax.eval_shape``) with its backend
reported as a TPU, its Pallas entry points (``linear_attention_folded``,
``flash_attention``) replaced by spies that record their token counts: its
dispatch as it runs (JAX ``models/attention.py:43,76-81,159``). At 256³ the
bottom stage has 16³ = 4096 tokens, so the flagship's full attention (the last
stage, down and up, and the middle) takes K3 there, which it does at no
smaller volume.
"""

import types
from unittest import mock

import jax
import jax.numpy as jnp
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.config import unconditional_64
from flowtrain_stochastic_interpolation_torch.models import attention
from flowtrain_stochastic_interpolation_torch.train.loop import build_model
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.models import attention as jax_attention
from flowtrain_stochastic_interpolation_tpu.ops import flash_attention as jax_flash
from flowtrain_stochastic_interpolation_tpu.ops import linear_attention as jax_linear
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

META = torch.device("meta")

# (side, the port's (path, tokens) per attention layer in call order but einsum's)
EXPECTED = {
    64: [("folded", n) for n in (64**3, 32**3, 16**3, 16**3, 32**3, 64**3)],
    128: [("folded", n) for n in (128**3, 64**3, 32**3, 16**3, 16**3, 32**3, 64**3, 128**3)],
    256: ([("folded", n) for n in (256**3, 128**3, 64**3, 32**3)] + [("flash", 16**3)] * 3
          + [("folded", n) for n in (32**3, 64**3, 128**3, 256**3)]),
}


def port_paths(side: int) -> list:
    """``(path, tokens)`` of every attention layer of the port's flagship at ``side``³,
    in call order, as each would dispatch on the card."""
    cfg = unconditional_64()
    model = build_model(cfg, device=META).eval()
    seen = []

    def record(module, args):
        n = args[0].shape[1:-1].numel()
        if isinstance(module, attention.LinearAttention):
            hidden = module.heads * module.dim_head
            on_card = types.SimpleNamespace(is_cuda=True, shape=(1, n, 3 * hidden))
            path = ("folded" if module.takes_folded(on_card)
                    else "v1" if module.takes_v1(n) else "einsum")
        else:
            path = "flash" if module.takes_flash(n) else "einsum"
        seen.append((path, n))

    for module in model.modules():
        if isinstance(module, (attention.LinearAttention, attention.Attention)):
            module.register_forward_pre_hook(record)
    x = torch.empty(1, side, side, side, cfg.data.embedding_dim, device=META)
    with torch.no_grad():
        model(x, torch.empty(1, device=META))
    return seen


@pytest.fixture(scope="module")
def jax_flagship():
    cfg = jax_config.unconditional_64()
    model = jax_build_model(cfg)
    x = jnp.zeros((1, 16, 16, 16, cfg.data.embedding_dim))
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, jnp.zeros((1,))))
    return cfg, model, params


def jax_paths(jax_flagship, side: int) -> list:
    """``(path, tokens)`` of every attention layer of the JAX flagship at ``side``³
    that takes a Pallas kernel on a TPU, in call order."""
    cfg, model, params = jax_flagship
    seen = []

    def folded(q, k, v, mem_k, mem_v, heads, backward=None):
        seen.append(("folded", q.shape[1]))
        return jnp.zeros(q.shape, q.dtype)

    def flash(q, k, v):
        seen.append(("flash", q.shape[1]))
        return jnp.zeros(q.shape, q.dtype)

    x = jax.ShapeDtypeStruct((1, side, side, side, cfg.data.embedding_dim), jnp.float32)
    t = jax.ShapeDtypeStruct((1,), jnp.float32)
    with mock.patch.object(jax_linear, "linear_attention_folded", folded), \
            mock.patch.object(jax_flash, "flash_attention", flash), \
            mock.patch.object(jax, "default_backend", lambda: "tpu"):
        jax.eval_shape(model.apply, params, x, t)
    return seen


def test_dispatch_thresholds_are_jax_s():
    for name in ("_FOLDED_LINEAR_MIN_TOKENS", "_FUSED_LINEAR_MIN_TOKENS", "_FLASH_MIN_TOKENS"):
        assert getattr(attention, name) == getattr(jax_attention, name), name


@pytest.mark.parametrize("side", [64, 128, 256])
def test_flagship_attention_dispatch_matches_jax(jax_flagship, side):
    port = port_paths(side)
    kernels = [(path, n) for path, n in port if path != "einsum"]
    assert kernels == EXPECTED[side]
    assert kernels == jax_paths(jax_flagship, side)
    # the rest take einsum, below every threshold: 8³ linear, 4³ full (and 8³ full at 128³)
    assert all(n < attention._FLASH_MIN_TOKENS for path, n in port if path == "einsum")
    assert len(port) == 11  # 4 stages' linear attention down and up, 3 full attentions
