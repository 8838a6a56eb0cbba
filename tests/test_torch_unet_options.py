"""The UNet constructor options of the port against the flax UNets (CPU).

Sinusoidal time, RandomFourier time (frozen features: buffers in the port,
the ``constants`` collection in JAX), self-conditioning (with and without
``x_self_cond``) and ``attn_enabled=False``, on ``UNet`` and on
``UNet3DCond`` v3 at the tiny 8³ preset, in f32 and bf16. Weights, x, ATb and
the self-conditioning input are drawn with numpy from a seed and handed to
both sides (``params_from_jax`` carries the constants into the buffers).

Tolerances: f32 1e-4 absolute, as the other tiny forwards. bf16 computes
every layer in bf16 on both sides, rounding in other places (the port takes
RMSNorm's norm in f32, say) and summing in another order: the LearnedFourier
tiny model's bf16 forward lies about 1e-2 from its f32 forward on each side
(relative L2), independently, so the two bf16 forwards are held to 3e-2, the
tolerance of ``chip_smoke.py``'s bf16 forwards against f32. The times are
exact in bf16 (0.25 and 0.625), since the model casts time to its compute
dtype before the embedding, where a rounded t moves the phase by up to
bandwidth·2^-9.

Then: a release directory written by the port with RandomFourier constants,
read back by both packages; and a train step, a checkpoint and the EMA that
leave the buffers alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.models import persistence
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_torch.train.steps import make_train_step
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.models import persistence as jax_persistence
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

from test_torch_unet import random_params

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

OPTIONS = {
    "sinusoidal": dict(time_sin_pos=True),
    "random_fourier": dict(time_learned_emb=False),
    "self_condition": dict(self_condition=True),
    "no_attention": dict(attn_enabled=False),
}
TIMES = np.array([0.25, 0.625], np.float32)  # exact in bf16
BF16_REL_L2 = 3e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several workers
    at once, and a full thread pool in each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(conditional: bool, dtype: str = "float32", **model):
    cfg = port_config.tiny_test(conditional=conditional)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=dtype, dropout=0.0, data_channels=cfg.data.embedding_dim, **model))


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pair(option: str, conditional: bool, dtype: str, seed: int = 0):
    """``(run_port, run_jax, x_sc, variables, port)`` for one option: each run
    takes the self-conditioning input (None where it is absent)."""
    cfg = _cfg(conditional, dtype, **OPTIONS[option])
    rng = np.random.default_rng(seed)
    shape = (2, 8, 8, 8, cfg.data.embedding_dim)
    x, atb, x_sc = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    atb *= rng.uniform(size=shape[:-1])[..., None] < 0.3
    jmodel = jax_build_model(jax_config.ExperimentConfig.from_dict(cfg.to_dict()))
    jx, jatb, jt = map(jnp.asarray, (x, atb, TIMES))
    variables = random_params(jmodel, jx, jt, seed, cfg.model.time_bandwidth,
                              atb=jatb if conditional else None)
    port = (UNet3DCond if conditional else UNet).from_config(cfg.model, device="cpu")
    port.load_state_dict(persistence.params_from_jax(variables, port))
    cond = (atb,) if conditional else ()
    apply = jax.jit(jmodel.apply)

    def run_jax(sc):
        return np.asarray(apply(variables, jx, *map(jnp.asarray, cond), jt,
                                *(() if sc is None else (jnp.asarray(sc),))))

    def run_port(sc):
        with torch.no_grad():
            return port(torch.from_numpy(x), *map(torch.from_numpy, cond),
                        torch.from_numpy(TIMES),
                        x_self_cond=None if sc is None else torch.from_numpy(sc)).numpy()

    return run_port, run_jax, x_sc, variables, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditional", [False, True], ids=["unet", "cond_v3"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_forward_matches_jax(option, conditional, dtype):
    run_port, run_jax, x_sc, variables, port = _pair(option, conditional, dtype)
    # self-conditioning with a non-zero input, and without one (JAX's zeros_like,
    # given to its compiled forward as zeros)
    cases = ([(x_sc, x_sc), (None, np.zeros_like(x_sc))] if option == "self_condition"
             else [(None, None)])
    for port_sc, jax_sc in cases:
        out, ref = run_port(port_sc), run_jax(jax_sc)
        assert out.shape == ref.shape == (2, 8, 8, 8, 15) and out.dtype == np.float32
        assert np.isfinite(out).all()
        if dtype == "float32":
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
        else:
            assert _rel_l2(out, ref) < BF16_REL_L2
    if option == "self_condition":  # the input matters, and zeros stand in for None
        assert not np.allclose(run_port(x_sc), run_port(None))
        np.testing.assert_array_equal(run_port(None), run_port(np.zeros_like(x_sc)))
    names = dict(port.named_modules())
    if option == "no_attention":
        assert not any("attn" in n for n in names) and "mid_attn" not in names
    if option == "random_fourier":
        assert set(variables["constants"]["time_mlp"]["embed"]) == {"freqs", "phases"}
        assert set(dict(port.named_buffers())) == {"time_mlp.embed.freqs",
                                                    "time_mlp.embed.phases"}
        assert not any(n.startswith("time_mlp.embed") for n, _ in port.named_parameters())
    conv = port.init_conv_x if conditional else port.init_conv
    assert conv.weight.shape[1] == 15 * (2 if option == "self_condition" else 1)


def test_x_self_cond_needs_a_self_conditioned_model():
    model = UNet.from_config(_cfg(False).model, device="cpu")
    x = torch.zeros(1, 8, 8, 8, 15)
    with pytest.raises(ValueError, match="self_condition"):
        model(x, torch.zeros(1), x_self_cond=x)


def test_release_round_trip_keeps_the_random_fourier_constants(tmp_path):
    cfg = _cfg(False, time_learned_emb=False)
    _, _, state = init_train_state(cfg, device="cpu")
    model = UNet.from_config(cfg.model, device="cpu")
    model.load_state_dict(state.model_state_dict())
    variables = persistence.variables_to_jax(model)
    assert set(variables) == {"params", "constants"}
    assert set(variables["constants"]["time_mlp"]["embed"]) == {"freqs", "phases"}
    persistence.save_release_weights(str(tmp_path), params=variables["params"],
                                     model_constants=variables["constants"],
                                     config_json=cfg.to_json(), step=3)
    # the port reads its own file: bf16 params, f32 constants exactly
    tree, read_cfg, meta = persistence.load_release_weights(str(tmp_path))
    assert meta["step"] == 3 and read_cfg.model == cfg.model
    back = persistence.state_dict_from_release(tree, model)
    for name in ("time_mlp.embed.freqs", "time_mlp.embed.phases"):
        assert torch.equal(back[name], model.state_dict()[name])
    # JAX reads it too, and its forward on those variables is the port's
    jtree, _, _ = jax_persistence.load_release_weights(str(tmp_path))
    np.testing.assert_array_equal(jtree["constants"]["time_mlp"]["embed"]["freqs"],
                                  variables["constants"]["time_mlp"]["embed"]["freqs"])
    port = UNet.from_config(cfg.model, device="cpu")
    port.load_state_dict(back)
    jmodel = jax_build_model(jax_config.ExperimentConfig.from_dict(cfg.to_dict()))
    x = np.random.default_rng(1).standard_normal((1, 8, 8, 8, 15)).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(
        {"params": jtree["params"], "constants": jtree["constants"]},
        jnp.asarray(x), jnp.asarray(TIMES[:1])))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(TIMES[:1])).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_optimiser_ema_and_checkpoints_leave_the_buffers_alone(tmp_path):
    cfg = _cfg(False, time_learned_emb=False)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, accumulate_grad_batches=1))
    model, tx, state = init_train_state(cfg, device="cpu")
    buffers = dict(model.named_buffers())
    before = {k: b.clone() for k, b in buffers.items()}
    assert not set(state.params) & set(buffers) and not set(state.ema_params) & set(buffers)
    assert all(state.constants["model." + k] is b for k, b in buffers.items())
    params_before = {k: p.detach().clone() for k, p in state.params.items()}
    step = make_train_step(model, tx, cfg)
    batch = torch.randint(-1, 14, (2, 8, 8, 8), generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32)
    for i in range(2):
        state, _ = step(state, batch, torch.Generator().manual_seed(i))
    assert any(not torch.equal(params_before[k], p) for k, p in state.params.items())
    for k, b in buffers.items():
        assert torch.equal(b, before[k]) and b.grad is None and not b.requires_grad
    # a checkpoint saves the buffers and a restore puts them back into the model
    mgr = CheckpointManager(str(tmp_path), cfg)
    mgr.save(state.step, state)
    _, _, fresh = init_train_state(dataclasses.replace(
        cfg, training=dataclasses.replace(cfg.training, seed=9)), device="cpu")
    assert not torch.equal(fresh.model_buffers()["time_mlp.embed.freqs"],
                           before["time_mlp.embed.freqs"])
    restored = mgr.restore(fresh)
    for k, b in restored.model_buffers().items():
        assert torch.equal(b, before[k])
    assert set(restored.model_state_dict(use_ema=True)) == set(model.state_dict())
