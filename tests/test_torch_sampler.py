"""The port's ``sample_unconditional`` against the JAX package's ``make_sampler``.

``tiny_test()`` UNet (8³, f32), the same numpy-drawn weights on both sides
(``params_from_jax``) and the same initial state: the port's seeded noise
(``initial_noise``) handed to JAX. 3 frames, 1 substep, Euler and RK4. The
final states agree at atol 1e-4 and the decoded maps on at least 99.9% of
voxels (a voxel near a tie between two categories may flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch import device as port_device
from flowtrain_stochastic_interpolation_torch.inference import (
    initial_noise,
    sample_unconditional,
)
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.ops.embedding import (
    simplex_embedding as port_simplex_embedding,
)
from flowtrain_stochastic_interpolation_tpu.inference import make_sampler
from flowtrain_stochastic_interpolation_tpu.models import UNet3D
from flowtrain_stochastic_interpolation_tpu.ops.embedding import simplex_embedding

SHAPE, E, SEED = (8, 8, 8), 15, 11


def _random_params(model, x, t, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, t)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "g":
            return 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        if name == "freqs":
            return 10.0 * rng.standard_normal(leaf.shape)
        if name == "phases":
            return rng.uniform(0.0, 1.0, leaf.shape)
        return 0.1 * rng.standard_normal(leaf.shape)  # bias, mem_kv

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_sample_unconditional_matches_jax_make_sampler(method):
    cfg = port_config.tiny_test()
    mc = cfg.model
    jax_model = UNet3D(
        dim=mc.dim, dim_mults=mc.dim_mults, data_channels=E, dropout=0.0,
        time_resolution=mc.time_resolution, time_bandwidth=mc.time_bandwidth,
        time_learned_emb=True, attn_dim_head=mc.attn_dim_head, attn_heads=mc.attn_heads,
        dtype=None,
    )
    variables = _random_params(jax_model, jnp.zeros((1, *SHAPE, E)), jnp.zeros((1,)), 0)
    port = UNet.from_config(mc, device="cpu").eval()
    port.load_state_dict(params_from_jax(variables, port))

    kw = dict(t0=cfg.inference.t0, tf=cfg.inference.tf, n_frames=3, substeps=1, method=method)
    result = sample_unconditional(
        port, torch.from_numpy(port_simplex_embedding(E, E)), n_samples=2, batch_size=2,
        data_shape=SHAPE, embedding_dim=E, seed=SEED, device="cpu", verbose=False,
        keep_trajectory=True, **kw,
    )
    x0 = initial_noise(torch.Generator().manual_seed(SEED), 2, SHAPE, E, torch.float32,
                       torch.device("cpu"))
    np.testing.assert_array_equal(result.trajectory[0], x0.numpy())

    table = jnp.asarray(simplex_embedding(E, E))
    ref = make_sampler(jax_model, variables, table, keep_trajectory=True, **kw)(
        jnp.asarray(x0.numpy())
    )
    ref_final = np.asarray(ref["trajectory"][-1])
    assert result.nfe == 2 * (4 if method == "rk4" else 1)
    assert result.trajectory.shape == (3, 2, *SHAPE, E)
    np.testing.assert_allclose(result.trajectory[-1], ref_final, rtol=0, atol=1e-4)
    agree = np.mean(result.decoded == np.asarray(ref["decoded"]))
    assert agree >= 0.999, agree


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UNet.from_config(port_config.tiny_test().model)
    model = UNet.from_config(port_config.tiny_test().model, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_unconditional(model, torch.eye(E), n_samples=1, batch_size=1,
                             data_shape=SHAPE, embedding_dim=E, verbose=False)


def test_embed_and_decode_match_jax():
    from flowtrain_stochastic_interpolation_torch.ops.embedding import decode, embed
    from flowtrain_stochastic_interpolation_tpu.ops import embedding as jax_embedding

    table = simplex_embedding(15, 18)
    np.testing.assert_array_equal(port_simplex_embedding(15, 18), table)
    rng = np.random.default_rng(4)
    idx = rng.integers(-1, 14, size=(2, 4, 4, 4))  # GeoGen convention: air = -1
    emb = embed(torch.from_numpy(idx), torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(emb, np.asarray(jax_embedding.embed(jnp.asarray(idx), jnp.asarray(table))))
    np.testing.assert_array_equal(decode(torch.from_numpy(emb), torch.from_numpy(table)).numpy(), idx + 1)
    noisy = emb + 0.3 * rng.standard_normal(emb.shape).astype(np.float32)
    np.testing.assert_array_equal(
        decode(torch.from_numpy(noisy), torch.from_numpy(table)).numpy(),
        np.asarray(jax_embedding.decode(jnp.asarray(noisy), jnp.asarray(table))),
    )


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_sampler_runs_the_model_in_eval_mode_and_restores_its_mode(mode):
    """After a train step (which leaves the model in training mode) two sampler
    calls from the same x0 agree exactly with each other and with a sample of
    the model put in eval mode by hand: no dropout while sampling, as the JAX
    sampler's ``deterministic=True``. The model's mode is handed back."""
    import dataclasses

    from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
    from flowtrain_stochastic_interpolation_torch.inference import make_sampler as port_sampler
    from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
    from flowtrain_stochastic_interpolation_torch.train.steps import make_train_step

    cfg = port_config.tiny_test()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.5))
    model, tx, state = init_train_state(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = make_train_step(model, tx, cfg)(
        state, synthetic_geology_batch(gen, 2, cfg.data.shape), gen)
    assert model.training
    model.train(mode == "train")

    table = torch.from_numpy(port_simplex_embedding(E, E))
    sampler = port_sampler(model, table, n_frames=3, substeps=1, method="euler",
                           keep_trajectory=True)
    x0 = initial_noise(torch.Generator().manual_seed(SEED), 2, SHAPE, E, torch.float32,
                       torch.device("cpu"))
    first, second = sampler(x0), sampler(x0)
    assert model.training == (mode == "train")
    model.eval()
    by_hand = sampler(x0)
    assert not model.training
    for other in (second, by_hand):
        torch.testing.assert_close(other["trajectory"], first["trajectory"], rtol=0, atol=0)
        assert torch.equal(other["decoded"], first["decoded"])
