"""The port's trajectory figures and the CLI's ``solve --plot`` /
``--animate`` against the JAX package's ``utils/plotting.py``.

The same numpy X, U and sigma (a 6-DoF trajectory with unit quaternions,
and a 3-DoF one, at small K) go through both packages' functions; every
line of every axis must carry the same data, the thrust arrows the same
segments, and the GIFs the same frame count.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from successiveconvexification_tpu.models import pointmass3dof as jpm
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.utils import plotting as jplot

from successiveconvexification_tpu_torch import cli
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.utils import plotting as tplot

from torch_helpers import ROOT, child_env

K = 9


def _trajectory(nx, nu, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, nx))
    X[:, 0] = 2.0 + 0.1 * rng.random(K)
    if nx >= 14:
        q = rng.standard_normal((K, 4))
        X[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return X, rng.standard_normal((K, nu)), 3.25


CASES = {
    "rocket6dof": (14, 3, jrk.default_params, trk.default_params),
    "pointmass3dof": (7, 3, jpm.default_params, tpm.default_params),
}


def _lines(fig):
    """Every axis's line data and 3D arrow segments, in order."""
    out = []
    for ax in fig.axes:
        for line in ax.get_lines():
            data = (line.get_data_3d() if hasattr(line, "get_data_3d")
                    else line.get_data())
            out.append(np.asarray(data, dtype=np.float64))
        for coll in ax.collections:
            out.append(np.asarray(coll._segments3d, dtype=np.float64))
    return out


@pytest.mark.parametrize("model", list(CASES))
def test_plot_trajectory_matches_jax(tmp_path, model):
    """The port's figure carries JAX's line data on every axis (within
    1e-12), with as many arrows, and its PNG exceeds 10 kB."""
    import matplotlib.pyplot as plt

    nx, nu, jparams, tparams = CASES[model]
    X, U, sigma = _trajectory(nx, nu, 0)
    fj = jplot.plot_trajectory(X, U, sigma, params=jparams(),
                               path=str(tmp_path / "j.png"))
    ft = tplot.plot_trajectory(torch.as_tensor(X), torch.as_tensor(U),
                               torch.tensor(sigma), params=tparams(),
                               path=str(tmp_path / "t.png"))
    try:
        lj, lt = _lines(fj), _lines(ft)
        assert len(lt) == len(lj) > 0
        if model == "rocket6dof":
            assert sum(len(ax.collections) for ax in ft.axes) == K
        for a, b in zip(lt, lj):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert [ax.get_title() for ax in ft.axes] == [
            ax.get_title() for ax in fj.axes]
    finally:
        plt.close(fj)
        plt.close(ft)
    assert os.path.getsize(tmp_path / "t.png") > 10_000


@pytest.mark.parametrize("model", list(CASES))
def test_animate_trajectory_matches_jax(tmp_path, model):
    """The GIF has JAX's frame count (one a node) and exceeds 10 kB, as
    the JAX package's tests/test_aux.py asks of its own."""
    from PIL import Image

    nx, nu, jparams, tparams = CASES[model]
    X, U, sigma = _trajectory(nx, nu, 1)
    jplot.animate_trajectory(X, U, sigma, params=jparams(),
                             path=str(tmp_path / "j.gif"), fps=5)
    tplot.animate_trajectory(X, U, sigma, params=tparams(),
                             path=str(tmp_path / "t.gif"), fps=5)
    with Image.open(tmp_path / "j.gif") as gj, \
            Image.open(tmp_path / "t.gif") as gt:
        assert gt.n_frames == gj.n_frames == K
    assert os.path.getsize(tmp_path / "t.gif") > 10_000


def test_cli_solve_writes_plot_and_animation(tmp_path):
    """``scvx solve --device cpu --K 8 --plot --animate`` in a child
    process writes both files."""
    png, gif = tmp_path / "traj.png", tmp_path / "traj.gif"
    out = subprocess.run(
        [sys.executable, "-m", "successiveconvexification_tpu_torch.cli",
         "solve", "--device", "cpu", "--K", "8", "--disc.substeps=2",
         "--scvx.max_iters=4", "--plot", str(png), "--animate", str(gif)],
        capture_output=True, text=True, timeout=120, env=child_env(),
        cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "plot written" in out.stdout and "animation written" in out.stdout
    assert os.path.getsize(png) > 10_000 and os.path.getsize(gif) > 10_000


def test_cli_plot_without_matplotlib_exits_naming_it(monkeypatch, tmp_path):
    """With matplotlib's import made to fail, ``--plot`` ends in a
    SystemExit that names it, before any solve, and writes nothing."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    png = tmp_path / "traj.png"
    with pytest.raises(SystemExit, match="matplotlib"):
        cli.main(["solve", "--device", "cpu", "--K", "8", "--plot", str(png)])
    assert not png.exists()
