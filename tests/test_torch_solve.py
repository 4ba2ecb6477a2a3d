"""The port's batched solve, run to convergence, against the JAX package's.

JAX side: a Python loop of ONE jitted ``vmap(scvx_iteration)`` until no lane
is alive. With Ruiz equilibration on for every solve
(``IPMConfig(equilibrate_cold_only=False)``) the general branch equals the
all-warm branch for lanes with a valid carry, so this loop reproduces the
JAX ``solve_batch`` step by step with a single compile. (With equilibration
off the f64 IPM paths of the two packages drift apart at the 1e-8 level and
the iteration counts can differ by one.) Port side: its own
``solve_batch`` (which takes the all-warm branch whenever it can) and its
``solve_batch_compact_device``. Inputs are numpy arrays from a seed; f64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.ops import scvx as jscvx

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.models import rocket6dof as trk

K, SUBSTEPS, B = 6, 2, 2


def _params_np(seed, batch):
    base = jrk.default_params(jnp.float64)
    rng = np.random.default_rng(seed)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (batch,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    d["r_init"] = d["r_init"] + 0.2 * rng.standard_normal((batch, 3))
    d["v_init"] = d["v_init"] + 0.1 * rng.standard_normal((batch, 3))
    d["m_wet"] = d["m_wet"] * (1.0 + 0.03 * rng.standard_normal(batch))
    return d


def _cfg_dict():
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=K, substeps=SUBSTEPS),
        ipm=J.IPMConfig(equilibrate_cold_only=False)).to_dict()


@pytest.fixture(scope="module")
def solved():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    try:
        yield _solve()
    finally:
        torch.set_num_threads(threads)


def _solve():
    d = _params_np(7, B)
    cfg_j = J.SolverConfig.from_dict(_cfg_dict())
    cfg_t = T.SolverConfig.from_dict(_cfg_dict())
    mj = J.rocket6dof_model()
    mt = T.rocket6dof_model()

    pj = jrk.Rocket6DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})
    sj = jax.jit(jax.vmap(lambda p: jscvx.scvx_init(mj, p, cfg_j)))(pj)
    step = jax.jit(jax.vmap(lambda p, s: jscvx.scvx_iteration(mj, p, cfg_j, s)))
    max_iters = cfg_j.scvx.max_iters
    while np.any(~np.asarray(sj.converged)
                 & (np.asarray(sj.iterations) < max_iters)):
        sj = step(pj, sj)

    pt = trk.params_from_numpy(d, device="cpu", dtype=torch.float64)
    st = T.solve_batch(mt, pt, cfg_t, device="cpu")
    sc = T.solve_batch_compact_device(mt, pt, cfg_t, chunk=3, min_bucket=1,
                                      device="cpu")
    return sj, st, sc


def test_solve_batch_matches_jax(solved):
    sj, st, _ = solved
    assert np.asarray(sj.converged).all()
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
    np.testing.assert_array_equal(st.iterations.numpy(),
                                  np.asarray(sj.iterations))
    np.testing.assert_allclose(st.sigma.numpy(), np.asarray(sj.sigma),
                               rtol=1e-6)


def test_compact_device_matches_solve_batch(solved):
    """Per-lane results do not depend on the packing. Lanes are independent,
    but CPU kernels may sum in another order for another batch size, and the
    SCvx loop carries that rounding along (measured ~3e-8 in sigma here), so
    the float comparisons use the JAX comparison's tolerance."""
    _, st, sc = solved
    for f in ("converged", "iterations", "n_accept", "n_reject", "n_bump"):
        np.testing.assert_array_equal(getattr(sc, f).numpy(),
                                      getattr(st, f).numpy(), err_msg=f)
    np.testing.assert_allclose(sc.sigma.numpy(), st.sigma.numpy(), rtol=1e-6)
    for f in ("X", "U"):
        np.testing.assert_allclose(getattr(sc, f).numpy(),
                                   getattr(st, f).numpy(), rtol=0, atol=1e-5,
                                   err_msg=f)


def test_warm_branch_equals_general_branch_for_valid_carry():
    """With Ruiz on for every solve, skipping the cold init changes nothing
    for lanes whose carry is valid — the premise of the JAX-side loop above."""
    cfg = T.SolverConfig.from_dict(_cfg_dict())
    m = T.rocket6dof_model()
    pt = trk.params_from_numpy(_params_np(3, 2), device="cpu",
                               dtype=torch.float64)
    st = T.scvx_iteration(m, pt, cfg, T.scvx_init(m, pt, cfg))
    assert torch.isfinite(st.ipm_carry.gap).all()
    a = T.scvx_iteration(m, pt, cfg, st, assume_warm_valid=True)
    b = T.scvx_iteration(m, pt, cfg, st, assume_warm_valid=False)
    for f in ("X", "U", "sigma", "ipm_gap"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0, atol=0)
