"""The port's host-compacting sweep (``solve_batch_compact``, ``scvx sweep
--compact host``) and the small helpers (``socp.cone_spec``, ``socp.dims``,
``rocket6dof.get_model``) against the JAX package's.

The lanes are those of the JAX package's ``tests/test_scvx.py:305-329``
(the point mass, f64, B=6 with r_init scaled lane by lane, IPM cap 20,
SCvx cap 25, ``chunk=5, min_bucket=2``), on the minimum-fuel problem
(fixed final time, w_sigma 0, w_mass 1) at K=8 with 2 substeps, where
every lane converges, in 17-19 iterations. (At that test's own free final
time and hard trust region every lane runs to the cap unconverged, and
there the two packages' iterates part by up to 14% in sigma: rounding
decides where a non-converging hard trust region goes, so that comparison
holds nothing.) On the port the host driver must give ``solve_batch``'s
converged set and iteration counts (and that test's trajectory tolerance),
and JAX's ``solve_batch_compact`` (a child process, run while this one
works) equal flags and counts with X and U within 1e-6 relative (sigma is
pinned). At ``chunk=2`` both drivers repack 6 lanes into 2, and there the
host driver must give ``solve_batch_compact_device``'s final state bit for
bit: both pack alike. The CLI runs in a second child: ``sweep --compact
host --device cpu --batch 4 --disc.K=8`` must exit 0 with the JAX CLI's
record keys.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.ops import socp as tsocp
from successiveconvexification_tpu_torch.parallel import batch as batch_mod
from successiveconvexification_tpu_torch.utils.tree import tree_leaves

from torch_helpers import finish, kill, spawn

F64 = torch.float64
SCALES = [1.0, 1.05, 0.95, 1.12, 0.9, 1.02]
CLI_KEYS = {"n_converged", "n_total", "mean_iterations", "mean_sigma",
            "max_nu_norm", "wall_s", "solves_per_s"}

_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import pointmass3dof as pm
from successiveconvexification_tpu.parallel.batch import solve_batch_compact

cfg = J.SolverConfig.from_dict(json.loads(sys.argv[1]))
params = pm.default_params(dtype=jnp.float64)
pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (6,) + jnp.shape(a)), params)
scales = jnp.asarray(json.loads(sys.argv[2]))[:, None]
pb = pb.replace(r_init=scales * params.r_init)
st = solve_batch_compact(pm.pointmass3dof_model(), pb, cfg, chunk=5,
                         min_bucket=2)
np.savez(sys.argv[3], converged=np.asarray(st.converged),
         iterations=np.asarray(st.iterations), sigma=np.asarray(st.sigma),
         X=np.asarray(st.X), U=np.asarray(st.U))
"""


def _cfg():
    """The minimum-fuel point mass at K=8 with tests/test_scvx.py:111-117's
    IPM settings and its SCvx cap of 25."""
    return T.SolverConfig(
        dtype="float64", disc=T.DiscretizationConfig(K=8, substeps=2),
        ipm=T.IPMConfig(max_iters=20, refine_steps=1),
        scvx=dataclasses.replace(T.ScvxConfig(), max_iters=25, w_sigma=0.0,
                                 w_mass=1.0),
        free_final_time=False)


def _lanes():
    p = tpm.default_params(F64)
    pb = p.map(lambda v, tail: v.expand((6,) + v.shape).clone())
    return pb.replace(r_init=torch.tensor(SCALES, dtype=F64)[:, None]
                      * p.r_init)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's ``solve_batch_compact`` and the CLI in children; the port's
    drivers here meanwhile, each chunk's batch size recorded."""
    out = tmp_path_factory.mktemp("compact")
    script = out / "worker.py"
    script.write_text(_WORKER)
    jax_npz = out / "jax.npz"
    procs = spawn([
        [str(script), json.dumps(_cfg().to_dict()),
         json.dumps(SCALES), str(jax_npz)],
        ["-m", "successiveconvexification_tpu_torch.cli", "sweep",
         "--compact", "host", "--device", "cpu", "--batch", "4",
         "--disc.K=8"]])
    model = T.pointmass3dof_model()
    pb = _lanes()
    sizes = []
    orig = batch_mod._solve_chunk

    def recording(model_, pb_, cfg_, chunk, st, mesh=None):
        sizes[-1].append(pb_.batch_shape[0])
        return orig(model_, pb_, cfg_, chunk, st, mesh)

    def run(driver, cfg, **kw):
        sizes.append([])
        return driver(model, pb, cfg, device="cpu", **kw)

    batch_mod._solve_chunk = recording
    try:
        res = {
            "plain": run(T.solve_batch, _cfg()),
            "host": run(T.solve_batch_compact, _cfg(), chunk=5, min_bucket=2),
            "host_repack": run(T.solve_batch_compact, _cfg(), chunk=2,
                               min_bucket=2),
            "device_repack": run(T.solve_batch_compact_device, _cfg(),
                                 chunk=2, min_bucket=2),
        }
        outs = finish(procs, timeout=240)
    finally:
        batch_mod._solve_chunk = orig
        kill(procs)
    with np.load(jax_npz) as z:
        res["jax"] = dict(z)
    res["cli"] = outs[1]
    res["sizes"] = dict(zip(("plain", "host", "host_repack", "device_repack"),
                            sizes))
    return res


def test_compact_batch_matches_plain(runs):
    """tests/test_scvx.py::test_compact_batch_matches_plain on the port: the
    host driver reproduces ``solve_batch`` lane for lane: the same converged
    set (every lane) and iteration counts, X within atol 5e-3, sigma within
    rtol 1e-3."""
    c, p = runs["host"], runs["plain"]
    assert bool(p.converged.all())
    np.testing.assert_array_equal(c.converged.numpy(), p.converged.numpy())
    np.testing.assert_array_equal(c.iterations.numpy(), p.iterations.numpy())
    np.testing.assert_allclose(c.X.numpy(), p.X.numpy(), atol=5e-3)
    np.testing.assert_allclose(c.sigma.numpy(), p.sigma.numpy(), rtol=1e-3)


def test_compact_batch_matches_jax(runs):
    """The same lanes through JAX's ``solve_batch_compact`` at the same
    ``chunk`` and ``min_bucket``: equal converged flags and iteration
    counts, sigma equal (pinned), X and U within 1e-6 relative (normwise,
    f64)."""
    c, j = runs["host"], runs["jax"]
    np.testing.assert_array_equal(c.converged.numpy(), j["converged"])
    np.testing.assert_array_equal(c.iterations.numpy(), j["iterations"])
    np.testing.assert_array_equal(c.sigma.numpy(), j["sigma"])
    for key in ("X", "U"):
        a, b = getattr(c, key).numpy(), j[key]
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), key


def test_host_and_device_compaction_agree_bit_for_bit(runs):
    """Where lanes finish at different iterations both drivers repack 6
    lanes into 2 at the same chunk, and the host driver's final state is
    the device driver's bit for bit, leaf by leaf; every lane converged."""
    h, d = runs["host_repack"], runs["device_repack"]
    sizes = runs["sizes"]
    assert sizes["host_repack"] == sizes["device_repack"]
    assert sizes["host_repack"][0] == 6 and sizes["host_repack"][-1] == 2
    assert bool(h.converged.all())
    leaves_h, leaves_d = tree_leaves(h), tree_leaves(d)
    assert len(leaves_h) == len(leaves_d) == 45
    for a, b in zip(leaves_h, leaves_d):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_cli_sweep_compact_host(runs):
    """``scvx sweep --compact host --device cpu --batch 4 --disc.K=8`` exits
    0 and prints one record with the JAX CLI's keys."""
    out = runs["cli"]
    rec = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert set(rec) == CLI_KEYS and rec["n_total"] == 4


@pytest.mark.parametrize("name", ["rocket6dof", "pointmass3dof"])
def test_cone_spec_and_dims_match_jax(name):
    """``socp.cone_spec`` and ``socp.dims`` equal the JAX package's for both
    models (the dict's key order too)."""
    from successiveconvexification_tpu.models import pointmass3dof as jpm
    from successiveconvexification_tpu.models import rocket6dof as jrk
    from successiveconvexification_tpu.ops import socp as jsocp

    jm, tm = ((jrk.rocket6dof_model(), trk.rocket6dof_model())
              if name == "rocket6dof" else
              (jpm.pointmass3dof_model(), tpm.pointmass3dof_model()))
    assert list(tsocp.cone_spec(tm).items()) == list(
        jsocp.cone_spec(jm).items())
    for K in (2, 50):
        assert tsocp.dims(tm, K) == jsocp.dims(jm, K)


def test_get_model_is_the_rocket():
    """``rocket6dof.get_model`` is the cached 6-DoF model, as the JAX
    package's alias is; the top level exports the host driver."""
    from successiveconvexification_tpu.models import rocket6dof as jrk

    assert trk.get_model() is trk.rocket6dof_model()
    assert trk.get_model().name == jrk.get_model().name
    assert "solve_batch_compact" in T.__all__
    assert T.solve_batch_compact is batch_mod.solve_batch_compact
