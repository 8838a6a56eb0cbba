"""The port's spatial-parallel primitives on 4 gloo ranks against JAX's under
``shard_map`` and against the port's unsharded ops.

The ranks (``tests/torch_parallel_cases.py::primitives``, spawned once for the
file, one torch thread each) run ``halo_conv3d`` at 3³ and 7³,
``sharded_resize3d`` at ×2 and ×0.5, ``ring_attention`` and
``sharded_linear_attention`` with memory K/V, and the gradients of each, and
convs whose halo is wider than the slab (one X plane a rank); the JAX side runs ``parallel/spatial.py`` on 4 of the 8 CPU devices, jitted.
Tolerances, f32 rounding: the convs and attention to 1e-5 of the largest
value compared (a 7³ conv sums 1,715 products per output); the resize to 8
ulps of the input's largest value (each output mixes at most 8 inputs, and
the port resizes Y and Z with ``F.interpolate`` where JAX contracts its
dense matrix); gradients the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from flowtrain_stochastic_interpolation_torch.models.resize import resize3d
from flowtrain_stochastic_interpolation_torch.parallel.launch import spawn
from flowtrain_stochastic_interpolation_torch.parallel.spatial import halo_exchange
from flowtrain_stochastic_interpolation_tpu.parallel import create_mesh
from flowtrain_stochastic_interpolation_tpu.parallel.spatial import (
    halo_conv3d as jax_halo_conv3d,
    ring_attention as jax_ring_attention,
    sharded_linear_attention as jax_sharded_linear_attention,
    sharded_resize3d as jax_sharded_resize3d,
)

import torch_parallel_cases as cases

SPATIAL = cases.SPATIAL
REL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def close(got, want, rel=REL, scale=None, err_msg=""):
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=err_msg)


@pytest.fixture(scope="module")
def ranks():
    return spawn(cases.primitives, SPATIAL, threads=1, deadline_s=240)


def joined(ranks, key, axis=1):
    return torch.cat([r[key] for r in ranks], dim=axis).numpy()


def summed(ranks, key, i):
    """Each rank's part of a replicated input's gradient, summed (a rank whose
    part is empty, as the memory keys' off rank 0, has None)."""
    return sum(r[key][i] for r in ranks if r[key][i] is not None).numpy()


def jax_sharded(f, *args, sharded):
    """``f`` under shard_map on a 1 x 4 mesh: ``sharded[i]`` says whether argument
    i is split along axis 1; the output is."""
    mesh = create_mesh(n_data=1, n_spatial=SPATIAL)
    specs = tuple(P(None, "spatial") if s else P() for s in sharded)
    return np.asarray(jax.jit(jax.shard_map(f, mesh=mesh, in_specs=specs,
                                            out_specs=P(None, "spatial")))(*args))


def unsharded_conv(x, w, b, cot):
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    k = w.shape[-1]
    y = F.conv3d(leaves[0].permute(0, 4, 1, 2, 3), leaves[1], leaves[2], padding=k // 2)
    y = y.permute(0, 2, 3, 4, 1)
    (y * cot).sum().backward()
    return y.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("k", [3, 7])
def test_halo_conv3d_matches_jax_and_the_unsharded_conv(ranks, k):
    x, w, b, cot = cases.conv_inputs(k)
    want, grads = unsharded_conv(x, w, b, cot)
    got = joined(ranks, f"conv{k}")
    ref = jax_sharded(lambda xs, ws, bs: jax_halo_conv3d(xs, ws, bs, "spatial"),
                      jnp.asarray(x.numpy()), jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy()),
                      jnp.asarray(b.numpy()), sharded=(True, False, False))
    close(got, ref)
    close(got, want)
    close(torch.cat([r[f"conv{k}_grads"][0] for r in ranks], dim=1).numpy(), grads[0])
    for i in (1, 2):  # the weight and bias gradients: each rank's part, summed
        close(summed(ranks, f"conv{k}_grads", i), grads[i])


@pytest.mark.parametrize("scale", [2.0, 0.5])
def test_sharded_resize3d_matches_jax_and_the_unsharded_resize(ranks, scale):
    x = cases.normal(1, (2, 16, 8, 8, 3))
    xl = x.clone().requires_grad_(True)
    want = resize3d(xl, scale)
    cot = cases.normal(2, tuple(want.shape))
    (want * cot).sum().backward()
    got = joined(ranks, f"resize{scale}")
    ref = jax_sharded(lambda xs: jax_sharded_resize3d(xs, scale, "spatial"),
                      jnp.asarray(x.numpy()), sharded=(True,))
    close(got, ref, 8 * EPS32, np.abs(x.numpy()).max())
    close(got, want.detach().numpy(), 8 * EPS32, np.abs(x.numpy()).max())
    # the gradient sums the cotangent over the outputs that read each input
    close(joined(ranks, f"resize{scale}_grad"), xl.grad.numpy(), 8 * EPS32,
          np.abs(xl.grad.numpy()).max())


def unsharded_attention(name, q, k, v, mk, mv):
    kk, vv = torch.cat([mk, k], dim=1), torch.cat([mv, v], dim=1)
    d = q.shape[-1]
    if name == "ring":
        logits = torch.einsum("bnhd,bmhd->bhnm", q, kk) * d**-0.5
        return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), vv)
    ctx = torch.einsum("bnhd,bnhe->bhde", torch.softmax(kk, dim=1), vv)
    return torch.einsum("bhde,bnhd->bnhe", ctx, torch.softmax(q, dim=-1) * d**-0.5)


JAX_ATTENTION = {"ring": jax_ring_attention, "linear": jax_sharded_linear_attention}


@pytest.mark.parametrize("name", ["ring", "linear"])
def test_sharded_attention_matches_jax_and_the_unsharded_attention(ranks, name):
    q, k, v, mk, mv, cot = cases.attention_inputs()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, mk, mv)]
    want = unsharded_attention(name, *leaves)
    (want * cot).sum().backward()
    got = joined(ranks, name)
    fn = JAX_ATTENTION[name]
    ref = jax_sharded(lambda qs, ks, vs, mks, mvs: fn(qs, ks, vs, "spatial", mem_k=mks,
                                                       mem_v=mvs),
                      *(jnp.asarray(t.numpy()) for t in (q, k, v, mk, mv)),
                      sharded=(True, True, True, False, False))
    close(got, ref)
    close(got, want.detach().numpy())
    for i, leaf in enumerate(leaves):
        if i < 3:  # q, k, v: each rank's block
            grad = torch.cat([r[f"{name}_grads"][i] for r in ranks], dim=1).numpy()
        else:  # the memory K/V: each rank's part, summed
            grad = summed(ranks, f"{name}_grads", i)
        close(grad, leaf.grad.numpy(), err_msg=f"{name} gradient {i}")


def test_halo_wider_than_the_slab_raises(ranks):
    """A halo wider than the slab no longer raises: it reaches over as many ranks
    as it needs and gives the unsharded conv; JAX's ``halo_exchange`` raises
    there (its boundary slices run past the slab)."""
    wide = cases.normal(3, cases.WIDE_X)
    want = F.pad(wide, (0, 0, 0, 0, 0, 0, 6, 6)).numpy()  # zeros past the global edges
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["wide_halo"].numpy(), want[:, r:r + 13])
    for k in (5, 7):
        x, w, b, cot = cases.wide_conv_inputs(k)
        want, grads = unsharded_conv(x, w, b, cot)
        close(joined(ranks, f"wide{k}"), want)
        close(torch.cat([r[f"wide{k}_grads"][0] for r in ranks], dim=1).numpy(), grads[0])
        for i in (1, 2):
            close(summed(ranks, f"wide{k}_grads", i), grads[i])
        with pytest.raises(TypeError, match="slice"):  # JAX slices past its slab
            jax_sharded(lambda xs, ws, bs: jax_halo_conv3d(xs, ws, bs, "spatial"),
                        jnp.asarray(x.numpy()), jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy()),
                        jnp.asarray(b.numpy()), sharded=(True, False, False))
    # one process: the halo is all zeros
    assert torch.equal(halo_exchange(torch.ones(1, 2, 2, 2, 1), None, 3),
                       F.pad(torch.ones(1, 2, 2, 2, 1), (0, 0, 0, 0, 0, 0, 3, 3)))
    assert halo_exchange(torch.ones(1, 2, 2, 2, 1), None, 2).shape == (1, 6, 2, 2, 1)
