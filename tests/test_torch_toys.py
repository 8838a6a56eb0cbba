"""The 2-D toys of the port against the JAX package (CPU).

* ``VelocityMLP`` with JAX's parameter tree carried by ``params_from_jax``:
  the same velocity within 1e-6 relative L2 (f32, sums in another order).
* The toy distributions' deterministic parts on JAX's own draws, exactly:
  ``Gaussian2d.transform``, ``GaussianMixed.combine`` and
  ``images_from_draws`` against ``Gaussian2d.sample``,
  ``GaussianMixed.sample`` and ``synthetic_images`` of the same keys.
* The port's mixture drawn from a seeded generator: its pick share, mean and
  covariance against the mixture's (200,000 samples; within 0.005, 0.02 and
  0.05, about four standard errors).
* ``apps.toy2d_images.train_and_sample`` at the JAX package's own test
  settings (40 steps, 16², dim 8, b32, lr 3e-3): the loss falls below 0.8 of
  its first value, and the samples stay within (-4, 4); ``apps.toy2d`` for 50
  steps, its trajectory figure drawn by ``main``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.apps import toy2d, toy2d_images
from flowtrain_stochastic_interpolation_torch.data import toy
from flowtrain_stochastic_interpolation_torch.models import VelocityMLP
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_tpu.data import toy as jax_toy
from flowtrain_stochastic_interpolation_tpu.models.mlp import VelocityMLP as JaxVelocityMLP

from test_torch_unet import random_tree

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_velocity_mlp_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 2)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    jax_model = JaxVelocityMLP()
    variables = random_tree(jax_model, (jnp.asarray(x), jnp.asarray(t)), 1, 3.0)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    port = VelocityMLP(device=CPU)
    port.load_state_dict(params_from_jax(variables, port))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (64, 2)
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)


def test_gaussian2d_transform_on_jax_draws():
    key = jax.random.PRNGKey(3)
    jax_dist, port = jax_toy.Gaussian2d(), toy.Gaussian2d(device=CPU)
    z = np.array(jax.random.normal(key, (1000, 2)))
    got = port.transform(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dist.sample(key, 1000)))
    np.testing.assert_array_equal(port.covariance.numpy(), np.asarray(jax_dist.covariance))


def test_mixture_combine_on_jax_draws():
    key, n = jax.random.PRNGKey(4), 1000
    jax_dist, port = jax_toy.GaussianMixed(), toy.GaussianMixed(device=CPU)
    # GaussianMixed.sample's own splits and draws
    k_pick, *k_comp = jax.random.split(key, 3)
    picks = jax.random.choice(k_pick, 2, (n,), p=jax_dist.weights)
    z = np.stack([np.array(jax.random.normal(k, (n, 2))) for k in k_comp])
    got = port.combine(torch.from_numpy(np.array(picks)).long(), torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_dist.sample(key, n)))


def test_images_from_jax_draws():
    key, n, size = jax.random.PRNGKey(5), 6, 24
    keys = jax.random.split(key, 7)  # synthetic_images' splits, in its order
    draws = {}
    for k, (name, (shape, low, high)) in zip(keys, toy.IMAGE_DRAWS.items()):
        u = jax.random.uniform(k, (n, *shape), jnp.float32, low, high)
        draws[name] = torch.from_numpy(np.array(u))
    got = toy.images_from_draws(draws, size).numpy()
    want = np.asarray(jax_toy.synthetic_images(key, n, size))
    assert got.shape == want.shape == (n, size, size, 1)
    np.testing.assert_array_equal(got, want)


def test_mixture_moments():
    dist = toy.GaussianMixed(device=CPU)
    gen = torch.Generator().manual_seed(0)
    picks, z = dist.draw(gen, 200_000)
    x = dist.combine(picks, z).double().numpy()
    assert abs((picks == 0).double().mean().item() - 0.6) < 0.005
    np.testing.assert_allclose(x.mean(axis=0), [-0.4, -0.4], atol=0.02)
    w = dist.weights.double().numpy()
    means = np.stack([c.mean.double().numpy() for c in dist.components])
    covs = np.stack([c.covariance.double().numpy() for c in dist.components])
    mean = w @ means
    cov = sum(wi * (ci + np.outer(mi - mean, mi - mean)) for wi, ci, mi in zip(w, covs, means))
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.05)


def test_synthetic_images_range_and_seed():
    gen = lambda: torch.Generator().manual_seed(1)
    a = toy.synthetic_images(gen(), 8, size=24)
    assert a.shape == (8, 24, 24, 1)
    assert a.min() >= -1.0 and a.max() <= 1.0
    assert (a.reshape(8, -1).std(dim=1) > 0.05).all()
    assert torch.equal(toy.synthetic_images(gen(), 8, size=24), a)


def test_image_toy_training_reduces_loss():
    result = toy2d_images.train_and_sample(
        steps=40, size=16, dim=8, batch_size=32, lr=3e-3, out=None, use_mnist=False,
        n_grid=2, verbose=False, device="cpu")
    assert result["source"] == "synthetic_images"
    assert result["loss_last"] < 0.8 * result["loss_first"]
    lo, hi = result["sample_minmax"]
    assert -4.0 < lo < hi < 4.0
    assert result["samples"].shape == (2, 16, 16, 1)


def test_toy2d_app(tmp_path):
    out = str(tmp_path / "toy2d.png")
    result = toy2d.main(["--device", "cpu", "--steps", "50", "--out", out])
    assert result["trajectory"].shape == (toy2d.N_FRAMES, toy2d.N_SAMPLES, 2)
    assert np.isfinite(result["trajectory"]).all()
    assert result["losses"][0][0] == 0 and np.isfinite(result["losses"][0][1])
    assert os.path.getsize(out) > 10_000
