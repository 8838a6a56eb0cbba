"""The port's tap-folded conv (K5a, K5b and the custom VJP) against the JAX package's.

The JAX side runs ``tap_conv3d`` (``_fwd_kernel`` and ``_dw_kernel``) under
``pltpu.force_tpu_interpret_mode()``, as ``tests/test_tap_conv.py`` does. The
port's side is ``tap_conv3d`` on CPU tensors, whose kernel wrappers run the
plain PyTorch versions. Inputs are drawn with numpy from a seed and handed to
both. Both sum exact products in f32 in another order and round once to the
output dtype: f32 outputs within rtol 1e-4 and atol 1e-4 (as
``tests/test_tap_conv.py``), bf16 outputs within one bf16 ulp plus 1e-3·RMS;
the gradients within rtol 5e-3 and atol 1e-3 (as its VJP test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.ops import tap_conv as tc
from flowtrain_stochastic_interpolation_tpu.ops import tap_conv as jax_tc


def _draw(seed, batch, spatial, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *spatial, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b


def _assert_ulp_close(out, ref):
    rms = np.sqrt(np.mean(ref**2))
    ulp = np.abs(ref) * 2.0**-7  # one bf16 ulp is at most 2^-7 of the value
    assert np.all(np.abs(out - ref) <= ulp + 1e-3 * rms), np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,spatial,cin,cout", [
    (2, (8, 8, 8), 5, 7),      # minimum tile, odd channels (tests/test_tap_conv.py)
    (2, (16, 8, 16), 3, 4),    # several x tiles, the 16-deep z chunk (the same)
    (1, (8, 8, 8), 18, 48),    # the 18-channel input class: K = 27·18 is ragged
    # the widths of the card's box kernel: Z = 24 is one and a half of its
    # 16-voxel boxes, and 96 -> 96 streams w tap by tap
    (1, (8, 16, 24), 48, 48),
    (1, (8, 8, 16), 96, 96),
])
def test_tap_conv_matches_jax_pallas_interpret(batch, spatial, cin, cout, dtype):
    x, w, b = _draw(cin * cout, batch, spatial, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_tc.tap_conv3d(jnp.asarray(x, getattr(jnp, dtype)),
                                jnp.asarray(w, getattr(jnp, dtype)), jnp.asarray(b))
    ref = np.asarray(ref.astype(jnp.float32))
    tc.reset_launch_counts()
    out = tc.tap_conv3d(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(w).to(getattr(torch, dtype)), torch.from_numpy(b))
    assert tc.launch_counts == {"tap_conv_forward": 0, "tap_conv_weight_grad": 0}
    assert out.dtype == getattr(torch, dtype) and out.shape == (batch, *spatial, cout)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    else:
        _assert_ulp_close(out, ref)


def _loss_np(y):
    return np.sum(np.sin(y) * y)


@pytest.mark.parametrize("dtype,batch,cin,cout", [
    ("float32", 1, 3, 5),      # tests/test_tap_conv.py's VJP case
    ("bfloat16", 2, 8, 16),
])
def test_tap_conv_vjp_matches_jax_custom_vjp(dtype, batch, cin, cout):
    """dx, dw and db through the port's autograd function against JAX's custom
    VJP (interpret mode), for the loss sum(sin(y)·y) of tests/test_tap_conv.py."""
    x, w, b = _draw(cin + cout, batch, (8, 8, 8), cin, cout)

    def loss(x, w, b):
        y = jax_tc.tap_conv3d(x, w, b).astype(jnp.float32)
        return jnp.sum(jnp.sin(y) * y)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x, getattr(jnp, dtype)),
                                                 jnp.asarray(w, getattr(jnp, dtype)),
                                                 jnp.asarray(b))
    tensors = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(),
               torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_(),
               torch.from_numpy(b).requires_grad_()]
    y = tc.tap_conv3d(*tensors).float()
    torch.sum(torch.sin(y) * y).backward()
    for name, t, r in zip(("dx", "dw", "db"), tensors, want):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   rtol=5e-3, atol=1e-3, err_msg=name)


def test_tap_conv_db_carries_the_bf16_rounding_of_the_sum():
    """A bf16 cotangent: db is the bf16 rounding of the f32 sum over B, X, Y, Z
    (JAX's ``jnp.sum`` of a bf16 g returns bf16), cast to b's dtype."""
    x, w, b = _draw(7, 2, (8, 8, 8), 4, 6)
    tensors = [torch.from_numpy(x).bfloat16().requires_grad_(),
               torch.from_numpy(w).bfloat16().requires_grad_(),
               torch.from_numpy(b).requires_grad_()]
    g = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 8, 8, 8, 6))
                         .astype(np.float32) + 3.0).bfloat16()
    tc.tap_conv3d(*tensors).backward(g)
    exact = g.float().sum(dim=(0, 1, 2, 3))
    db = tensors[2].grad
    assert db.dtype == torch.float32
    assert torch.equal(db, exact.bfloat16().float())
    assert not torch.equal(db, exact)  # the rounding shows at these values
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_tc.tap_conv3d, *(jnp.asarray(t.detach().float().numpy(), d)
                                            for t, d in zip(tensors, (jnp.bfloat16,) * 2 +
                                                            (jnp.float32,))))
        jax_db = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))[2]
    np.testing.assert_allclose(db.numpy(), np.asarray(jax_db), rtol=2.0**-8, atol=0)


SPATIAL = [(8, 8, 8), (64, 64, 64), (12, 64, 64), (64, 12, 64), (64, 64, 60), (16, 8)]


@pytest.mark.parametrize("spatial", SPATIAL)
def test_use_tap_conv_gives_the_jax_answers(spatial):
    for cin, cout in [(48, 48), (3, 128), (256, 129), (257, 48), (96, 144)]:
        for kernel in (3, 5):
            assert tc.use_tap_conv(spatial, cin, cout, kernel) == jax_tc.use_tap_conv(
                spatial, cin, cout, kernel), (spatial, cin, cout, kernel)


@pytest.mark.parametrize("spatial,cin,cout,kernel", [
    ((12, 8, 8), 4, 4, 3),     # X not a multiple of 8 (the TPU grid drops rows here)
    ((8, 12, 8), 4, 4, 3),     # Y
    ((8, 8, 4), 4, 4, 3),      # Z
    ((8, 8, 8), 4, 136, 3),    # Cout past the lane width
    ((8, 8, 8), 264, 8, 3),    # Cin past the patch scratch
    ((8, 8, 8), 4, 4, 5),      # not a 3³ kernel
])
def test_tap_conv3d_raises_where_use_tap_conv_rejects(spatial, cin, cout, kernel):
    assert not jax_tc.use_tap_conv(spatial, cin, cout, kernel)
    x = torch.zeros(1, *spatial, cin)
    w = torch.zeros(kernel, kernel, kernel, cin, cout)
    with pytest.raises(ValueError, match="tap_conv3d takes"):
        tc.tap_conv3d(x, w, torch.zeros(cout))
