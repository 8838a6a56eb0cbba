"""The interpolant figure and the inference notebook of the port.

``tools.plot_interpolants``' line data against the JAX package's
interpolants on the same 100 times, to 1e-6, and its picture. The notebook
that ``tools.build_notebook --skip-exec`` writes: its code cells run in one
namespace, in this process, at the tiny preset on the CPU (the quick training
cut from 300 to 40 steps), and no cell imports JAX or the JAX package.
"""

import contextlib
import io
import json
import re

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.tools import build_notebook, plot_interpolants
from flowtrain_stochastic_interpolation_tpu import interpolants as jax_interpolants

matplotlib.use("Agg")

CURVE_TOL = 1e-6
NOTEBOOK_STEPS = 40


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_interpolant_curves_match_jax():
    curves = plot_interpolants.interpolant_curves("cpu")
    t = jnp.linspace(0.0, 1.0, 100)
    np.testing.assert_allclose(curves["t"]["t"], np.asarray(t), rtol=0, atol=CURVE_TOL)
    jax_set = [jax_interpolants.LinearInterpolant(one_sided=True),
               jax_interpolants.TrigInterpolant(one_sided=True),
               jax_interpolants.EncDecInterpolant(), jax_interpolants.SBDMInterpolant(),
               jax_interpolants.MirrorInterpolant()]
    assert list(curves)[1:] == [type(i).__name__ for i in jax_set]
    for interp in jax_set:
        for row in plot_interpolants.ROWS:
            for name in row:
                want = np.broadcast_to(np.asarray(getattr(interp, name)(t)), (100,))
                got = curves[type(interp).__name__][name]
                np.testing.assert_allclose(got, want, rtol=CURVE_TOL, atol=CURVE_TOL,
                                           err_msg=f"{type(interp).__name__}.{name}")


def test_the_figure_is_written(tmp_path):
    out = tmp_path / "interpolants.png"
    with contextlib.redirect_stdout(io.StringIO()):
        plot_interpolants.main([str(out), "--device", "cpu"])
    assert out.stat().st_size > 10_000


@pytest.fixture(scope="module")
def notebook(tmp_path_factory):
    out = tmp_path_factory.mktemp("nb") / "demo.ipynb"
    with contextlib.redirect_stdout(io.StringIO()):
        build_notebook.main(["--skip-exec", "--device", "cpu", "--out", str(out)])
    return json.loads(out.read_text())


def _code(nb) -> list:
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


def test_no_cell_imports_jax(notebook):
    for cell in notebook["cells"]:
        source = "".join(cell["source"])
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|"
                             r"flowtrain_stochastic_interpolation_tpu)\b", source, re.M), source
        assert "flowtrain_stochastic_interpolation_tpu" not in source


def test_the_notebooks_cells_run_in_one_namespace(notebook):
    cells = _code(notebook)
    assert cells[0].splitlines()[1] == "DEVICE = 'cpu'"
    assert sum("TRAIN_STEPS = 300" in c for c in cells) == 1
    namespace = {}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        for source in cells:
            exec(compile(source.replace("TRAIN_STEPS = 300", f"TRAIN_STEPS = {NOTEBOOK_STEPS}"),
                         "<cell>", "exec"), namespace)
    assert len(namespace["losses"]) == NOTEBOOK_STEPS // 20
    assert [s.shape for s in namespace["solutions"]] == [(6, 8, 8, 8)] * 2
    assert all(0.0 <= a <= 1.0 for a in namespace["obs_acc"])
    assert "observed-voxel accuracy of most-probable model" in out.getvalue()
    matplotlib.pyplot.close("all")
