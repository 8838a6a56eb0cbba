"""The port's figure code: ``tests/test_figures.py`` on the port's apps, and the
plots, the figure apps' numbers and ``tensorprocessor`` against the JAX package.

The figures are matplotlib's on the CPU (no PyVista here: the volume views
take their fallbacks). Where a figure comes from numbers, the numbers are held
to JAX's: the interpolation sequence on the same tensors (f32, 1e-6), the
uint8 images exactly, the raw tensors' decode exactly.
"""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.apps import paper_figures, tensorprocessor
from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_stages
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.utils import plotting
from flowtrain_stochastic_interpolation_torch.utils import volview as vv
from flowtrain_stochastic_interpolation_tpu.interpolants import (
    LinearInterpolant as JaxLinearInterpolant,
)
from flowtrain_stochastic_interpolation_tpu.utils import plotting as jax_plotting

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def vol():
    rng = np.random.default_rng(0)
    v = rng.integers(-1, 14, size=(16, 16, 16)).astype(np.int32)
    v[..., -3:] = -1  # air on top
    return v


def jax_app(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "apps", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_volume_view_builders(tmp_path, vol):
    assert os.path.exists(vv.volview(vol, str(tmp_path / "volview.png")))
    assert os.path.exists(vv.dike_view(vol, str(tmp_path / "dikes.png")))
    bore = np.where(np.random.default_rng(1).random(vol.shape) < 0.05, vol, -1)
    assert os.path.exists(vv.model_and_boreholes_figure(vol, bore, str(tmp_path / "mb.png")))
    assert os.path.exists(vv.realization_sheet([vol, vol, vol], str(tmp_path / "sheet.png"),
                                               rows=1, cols=3))
    prob = np.random.default_rng(2).random(vol.shape).astype(np.float32)
    assert os.path.exists(vv.probability_contour_view(
        prob, str(tmp_path / "contours.png"), observations=vol == 13))
    assert os.path.exists(vv.sample_row_figure([vol, vol, vol], str(tmp_path / "row.png")))
    assert os.path.exists(vv.standalone_scalarbar(str(tmp_path / "bar.png")))


def test_paper_figures_app_end_to_end(tmp_path, vol):
    """``python -m ...apps.paper_figures`` over a synthetic scenario directory
    and a samples directory."""
    sdir = tmp_path / "exp" / "scenario_0"
    sdir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    np.save(sdir / "true_model.npy", vol)
    np.save(sdir / "boreholes.npy", np.where(rng.random(vol.shape) < 0.05, vol, -1))
    np.save(sdir / "dike_probability.npy", rng.random(vol.shape).astype(np.float32))
    np.save(sdir / "entropy_air_masked.npy", rng.random(vol.shape).astype(np.float32))
    samples = tmp_path / "samples"
    samples.mkdir()
    for i in range(3):
        np.save(sdir / f"sol_{i}.npy", vol)
        np.save(samples / f"decoded_{i}.npy", vol)
    out_dir = tmp_path / "figs"
    res = subprocess.run(
        [sys.executable, "-m", "flowtrain_stochastic_interpolation_torch.apps.paper_figures",
         "--experiments-dir", str(tmp_path / "exp"), "--out-dir", str(out_dir),
         "--samples-dir", str(samples)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    produced = os.listdir(out_dir)
    for want in ["scenario_0_dike_prob.png", "scenario_0_entropy.png",
                 "scenario_0_realizations.png", "scenario_0_volview.png",
                 "scenario_0_dikes_true.png", "scenario_0_model_boreholes.png",
                 "scenario_0_realization_sheet.png", "scenario_0_prob_contours.png",
                 "uncond_samples_0.png", "uncond_samples_row.png",
                 "uncond_samples_scalarbar.png"]:
        assert want in produced, f"missing {want}: {produced}"


def test_geoprocess_stages_figure(tmp_path):
    """The transformation stages of the port's generator: each changes the
    volume, strata are flat layers, the last stage is the generator's output;
    the figure renders."""
    gen = torch.Generator().manual_seed(0)
    stages = {k: v.numpy() for k, v in synthetic_geology_stages(gen, (16, 16, 16)).items()}
    assert set(stages) == {"strata", "tilt", "fold", "dike", "topography"}
    strata = stages["strata"]
    assert (strata == strata[:1, :1, :]).all(), "strata must be flat layers"
    assert (stages["tilt"] != strata).any()
    assert (stages["fold"] != stages["tilt"]).any()
    assert (stages["topography"] == -1).any(), "air carved"
    out = str(tmp_path / "geoprocess_stages.png")
    paper_figures.geoprocess_stages_figure(out, shape=(16, 16, 16), n_examples=2, device="cpu")
    assert os.path.exists(out) and os.path.getsize(out) > 10_000


def test_interpolation_sequence_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    x0, x1 = (rng.standard_normal((3, 8, 8, 1)).astype(np.float32) for _ in range(2))
    got = plotting.make_interpolation_sequence(
        LinearInterpolant(one_sided=True), torch.from_numpy(x0), torch.from_numpy(x1),
        n_steps=5)
    want = jax_plotting.make_interpolation_sequence(
        JaxLinearInterpolant(one_sided=True), jnp.asarray(x0), jnp.asarray(x1), n_steps=5)
    assert got.shape == want.shape == (5, 3, 8, 8, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(plotting.denormalize_images(got),
                                  jax_plotting.denormalize_images(want))
    assert plotting.show_time_series(got, save_path=str(tmp_path / "ts.png")) is None
    assert plotting.show_images(got[-1], n_cols=2, save_path=str(tmp_path / "g.png")) is None
    for fn in ("make_interpolation_gif", "animate_batch"):
        frames = got[:, 0] if fn == "make_interpolation_gif" else got
        ours = getattr(plotting, fn)(frames, str(tmp_path / f"{fn}.gif"))
        theirs = getattr(jax_plotting, fn)(frames, str(tmp_path / f"jax_{fn}.gif"))
        assert ours == theirs
        if ours:
            gif = lambda prefix: (tmp_path / f"{prefix}{fn}.gif").read_bytes()
            assert gif("") == gif("jax_")


def test_volume_plots(tmp_path, vol):
    traj = np.random.default_rng(5).standard_normal((6, 10, 2))
    bore = np.where(np.random.default_rng(6).random(vol.shape) < 0.05, vol, -1)
    assert plotting.pyvista_available() == jax_plotting.pyvista_available()
    for name, call in [
        ("traj", lambda p: plotting.plot_trajectories(traj, save_path=p)),
        ("sols", lambda p: plotting.show_solutions(np.stack([vol, vol]), save_path=p)),
        ("mb", lambda p: plotting.show_model_and_boreholes(vol, bore, save_path=p)),
        ("vol", lambda p: plotting.plot_volume(vol, save_path=p)),
        ("slices", lambda p: plotting.plot_2d_slices(vol, save_path=p)),
        ("prom", lambda p: plotting.plot_prominence_maps(vol / 14.0, save_path=p)),
    ]:
        path = str(tmp_path / f"{name}.png")
        assert call(path) is None and os.path.getsize(path) > 2_000, name


def test_tensorprocessor_decodes_as_jax(tmp_path, vol):
    table = tensorprocessor.load_embedding(None)
    jax_tp = jax_app("tensorprocessor")
    np.testing.assert_array_equal(table, jax_tp.load_embedding(None))
    raw = np.random.default_rng(7).standard_normal((8, 8, 8, 18)).astype(np.float32)
    got = tensorprocessor.decode_with_loaded_embedding(raw, table, device="cpu")
    np.testing.assert_array_equal(got, jax_tp.decode_with_loaded_embedding(raw, table))
    folder = tmp_path / "tensors"
    folder.mkdir()
    np.save(folder / "decoded_0.npy", vol)
    np.save(folder / "raw_0.npy", raw)
    tensorprocessor.main([str(folder), "--device", "cpu"])
    rendered = sorted(os.listdir(folder / "rendered"))
    assert rendered == ["decoded_0_slices.png", "decoded_0_view.png",
                        "raw_0_slices.png", "raw_0_view.png"]
