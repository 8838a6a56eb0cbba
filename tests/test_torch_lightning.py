"""The reference's Lightning ``.ckpt`` through the port against the JAX converter.

Checkpoints are written in the reference's file layout by
``tests/torch_lightning_layout.py`` from a seeded port model's flax variables
(``variables_to_jax``), with an EMA shadow from other seeded weights: the
unconditional and the conditional (v3) tiny models, with LearnedFourier and
RandomFourier time, each read with and without ``use_ema``. The port's
``convert_lightning_module`` must equal JAX's leaf by leaf, exactly; JAX's
``_Mapper`` must read every ``net.*`` key written; the converted tree must
be the weights written (the EMA shadow's with ``use_ema``); and a tiny f32
forward of the model that the port's ``load_weights`` builds from the file
must match JAX's forward on JAX's conversion (1e-4 absolute, as the other
tiny forwards). Last, the port's unconditional app samples from a
RandomFourier ``.ckpt`` on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.apps import unconditional as port_app
from flowtrain_stochastic_interpolation_torch.models import persistence
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.train.loop import init_model_variables
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.models import persistence as jax_persistence
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

from torch_lightning_layout import write_checkpoint

TIMES = np.array([0.3, 0.8], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(conditional: bool, learned: bool):
    cfg = port_config.tiny_test(conditional=conditional)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", time_learned_emb=learned))


def _hyper_parameters(cfg) -> dict:
    """The flat hyper-parameters a reference module saves: its model options."""
    hp = dataclasses.asdict(cfg.model)
    hp.update(data_channels=cfg.data.embedding_dim, dim_mults=list(cfg.model.dim_mults))
    return hp


def _write(path, conditional: bool, learned: bool):
    """A reference-layout checkpoint of seeded weights with another seed's EMA
    shadow: ``(variables, ema params, table)`` as written."""
    cfg = _cfg(conditional, learned)
    variables = persistence.variables_to_jax(init_model_variables(cfg, seed=1, device="cpu"))
    ema = persistence.variables_to_jax(init_model_variables(cfg, seed=2, device="cpu"))["params"]
    table = simplex_embedding(cfg.data.num_categories, cfg.data.embedding_dim)
    write_checkpoint(str(path), variables, table, _hyper_parameters(cfg),
                     conditional=conditional, ema_params=ema)
    return cfg, variables, ema, table


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, value in want.items():
        assert got[path].dtype == np.float32, path
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


@functools.lru_cache(maxsize=None)
def _jax_forward(conditional: bool, learned: bool):
    """JAX's jitted forward of the tiny model (one compile per structure)."""
    cfg = jax_config.ExperimentConfig.from_dict(_cfg(conditional, learned).to_dict())
    return jax.jit(jax_build_model(cfg).apply)


@pytest.mark.parametrize("use_ema", [False, True], ids=["weights", "ema"])
@pytest.mark.parametrize("learned", [True, False], ids=["learned_fourier", "random_fourier"])
@pytest.mark.parametrize("conditional", [False, True], ids=["unet", "cond_v3"])
def test_conversion_matches_jax_leaf_by_leaf(tmp_path, monkeypatch, conditional, learned,
                                             use_ema):
    path = tmp_path / "ref.ckpt"
    cfg, variables, ema, table = _write(path, conditional, learned)

    mappers = []

    class Recording(jax_persistence._Mapper):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            mappers.append(self)

    monkeypatch.setattr(jax_persistence, "_Mapper", Recording)
    want = jax_persistence.convert_lightning_module(
        jax_persistence.load_lightning_checkpoint(str(path)), conditional=conditional,
        use_ema=use_ema)
    ckpt = persistence.load_lightning_checkpoint(str(path))
    got = persistence.convert_lightning_module(ckpt, conditional=conditional, use_ema=use_ema)

    # JAX's mapper reads every net.* key that the writer wrote
    net_keys = {k for k in ckpt["state_dict"] if k.startswith("net.")}
    assert len(mappers) == 1 and net_keys <= mappers[0].used
    # the shadow covers the trained weights: not RandomFourier's frozen features
    assert set(ckpt["ema_shadow"]) <= net_keys
    assert (set(ckpt["ema_shadow"]) == net_keys) == learned
    # the two converters agree exactly, and give back what was written
    assert set(got) == set(want) == {"params", "constants", "embedding"}
    _assert_same_tree(got["params"], want["params"])
    _assert_same_tree(got["constants"], want["constants"])
    np.testing.assert_array_equal(got["embedding"], want["embedding"])
    np.testing.assert_array_equal(got["embedding"], table)
    _assert_same_tree(got["params"], ema if use_ema else variables["params"])
    _assert_same_tree(got["constants"], variables.get("constants", {}))
    assert bool(got["constants"]) == (not learned)

    # a tiny forward: the port's load_weights on the file against JAX's conversion
    model, port_table = port_app.load_weights(cfg, str(path), use_ema=use_ema, device="cpu")
    assert torch.equal(port_table, torch.from_numpy(table))
    assert bool(dict(model.named_buffers())) == (not learned)
    rng = np.random.default_rng(3)
    shape = (2, 8, 8, 8, cfg.data.embedding_dim)
    x = rng.standard_normal(shape).astype(np.float32)
    cond = (rng.standard_normal(shape).astype(np.float32),) if conditional else ()
    jvars = {"params": want["params"], **({"constants": want["constants"]}
                                          if want["constants"] else {})}
    ref = np.asarray(_jax_forward(conditional, learned)(
        jvars, *map(jnp.asarray, (x, *cond, TIMES))))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (x, *cond, TIMES))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_unconditional_app_samples_from_a_random_fourier_ckpt(tmp_path, capsys):
    path = tmp_path / "uncond.ckpt"
    _write(path, conditional=False, learned=False)
    out = port_app.main(["--preset", "tiny", "--mode", "inference", "--checkpoint-path",
                         str(path), "--n-samples", "2", "--batch-size", "2",
                         "--infer-device", "cpu", "--no-save-images",
                         "--root-dir", str(tmp_path / "run")])
    printed = capsys.readouterr().out
    assert "loaded Lightning checkpoint" in printed and "EMA True" in printed
    assert "'time_learned_emb': False" in printed
    result = out["inference"]
    assert result.decoded.shape == (2, 8, 8, 8) and result.nfe > 0
    assert len(list((tmp_path / "run" / "samples" / "tiny-smoke").glob("decoded_*.npy"))) == 2
