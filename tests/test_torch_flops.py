"""The port's FLOP counter against the JAX package's jaxpr count.

``utils.flops.count_conv_dot_flops`` on the unit cases of ``tests/test_flops.py``
(a product, a batched product, a 3-D conv, a strided conv, a gradient), then
the tiny preset's forward and train micro-step counted on the ``meta`` device
against JAX's ``count_conv_dot_flops`` of the same configuration, within 0.1%,
and the flagship's forward counted on ``meta`` with no device at all.

What one side counts and the other does not: JAX's trilinear resize is one
interpolation matmul per axis (``models/resize.py``), a ``dot_general`` in its
count; the port's is ``F.interpolate``, which is not a product. The JAX side
is therefore counted with its gather form (``resize._USE_GATHER``, the same
values, no product), and, as ``bench.py``'s ``model_mfu`` count does, with its
direct convolutions (the TPU's packed and phase-fat forms carry structural
zeros).
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.utils import flops
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.models import resize as jax_resize
from flowtrain_stochastic_interpolation_tpu.ops import fat_conv, packed_conv
from flowtrain_stochastic_interpolation_tpu.utils.flops import count_conv_dot_flops as jax_count

REL = 1e-3
META = torch.device("meta")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_direct(monkeypatch):
    """JAX's model formulation without the resize's matmuls and with direct convs."""
    monkeypatch.setattr(jax_resize, "_USE_GATHER", True)
    monkeypatch.setattr(packed_conv, "use_packed_conv", lambda *a, **k: False)
    monkeypatch.setattr(fat_conv, "use_fat_conv", lambda *a, **k: False)


def test_dot_exact():
    a, b = torch.empty(128, 64, device=META), torch.empty(64, 256, device=META)
    assert flops.count_conv_dot_flops(torch.matmul, a, b) == 2 * 128 * 256 * 64


def test_batched_dot():
    a = torch.empty(4, 32, 16, dtype=torch.bfloat16, device=META)
    b = torch.empty(4, 16, 8, dtype=torch.bfloat16, device=META)
    got = flops.count_conv_dot_flops(lambda a, b: torch.einsum("bij,bjk->bik", a, b), a, b)
    assert got == 2 * 4 * 32 * 8 * 16


def test_conv3d_exact():
    x, w = torch.empty(2, 4, 8, 8, 8, device=META), torch.empty(16, 4, 3, 3, 3, device=META)
    got = flops.count_conv_dot_flops(lambda x, w: F.conv3d(x, w, padding=1), x, w)
    assert got == 2 * 2 * 512 * 16 * 4 * 27


def test_strided_conv_uses_output_spatial():
    x, w = torch.empty(1, 4, 16, 16, device=META), torch.empty(8, 4, 3, 3, device=META)
    got = flops.count_conv_dot_flops(lambda x, w: F.conv2d(x, w, stride=2, padding=1), x, w)
    assert got == 2 * 1 * 64 * 8 * 4 * 9  # output 8 x 8, not 16 x 16


def test_gradient_counts_transpose_matmuls():
    """Five products forward and five cotangent products back (with respect to
    ``a`` only), as ``test_flops.py``'s scan case."""
    a = torch.empty(64, 64, device=META, requires_grad=True)
    b = torch.empty(64, 64, device=META)

    def g(a):
        c = a
        for _ in range(5):
            c = torch.tanh(c @ b)
        c.sum().backward()

    assert flops.count_conv_dot_flops(g, a) == 10 * 2 * 64**3


def test_tiny_forward_matches_jax(jax_direct):
    from flowtrain_stochastic_interpolation_tpu.train.loop import (
        build_model,
        init_model_variables,
    )

    jcfg = jax_config.tiny_test()
    model = build_model(jcfg)
    variables = jax.eval_shape(lambda: init_model_variables(jcfg))  # shapes: no init
    x = jax.ShapeDtypeStruct((2, *jcfg.data.shape, jcfg.data.embedding_dim), jnp.float32)
    t = jax.ShapeDtypeStruct((2,), jnp.float32)
    want = jax_count(model.apply, variables, x, t)
    got = flops.forward_flops(port_config.tiny_test(), 2)
    assert want > 1e6
    assert abs(got - want) <= REL * want, (got, want)


def test_tiny_train_step_matches_jax(jax_direct):
    from flowtrain_stochastic_interpolation_tpu.train.loop import init_train_state
    from flowtrain_stochastic_interpolation_tpu.train.steps import make_train_step

    jcfg = jax_config.tiny_test()
    built = {}

    def init():
        built["model"], built["tx"], state = init_train_state(jcfg)
        return state

    state = jax.eval_shape(init)  # shapes: no init
    model, tx = built["model"], built["tx"]
    batch = jax.ShapeDtypeStruct((jcfg.data.batch_size, *jcfg.data.shape), jnp.int32)
    want = jax_count(make_train_step(model, tx, jcfg), state, batch, jax.random.PRNGKey(0))
    pcfg = port_config.tiny_test()
    assert pcfg.data.batch_size == jcfg.data.batch_size
    got = flops.micro_step_flops(pcfg)
    assert abs(got - want) <= REL * want, (got, want)


def test_flagship_forward_on_meta_needs_no_device(monkeypatch):
    """The 64³ b8 flagship forward: counted on ``meta`` with CUDA reported absent
    and every kernel wrapper made to fail, so nothing ran on a device."""
    from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
    from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module, name in ((la, "folded_context"), (la, "folded_project"),
                         (fa, "flash_attention_forward")):
        monkeypatch.setattr(module, name, lambda *a, **k: pytest.fail("a kernel ran"))
    cfg = port_config.unconditional_64()
    got = flops.forward_flops(cfg, 8)
    assert 5e12 < got < 7e12
    # the count scales with the batch: nothing depends on data
    assert flops.forward_flops(cfg, 4) == got / 2
