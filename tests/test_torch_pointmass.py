"""The port's 3-DoF point-mass model against the JAX package's, on the CPU.

The model of BASELINE config 1 (fixed final time) and of the JAX CLI: its
dynamics and their Jacobians, its stage cones, the plain discretize (the
discretize kernel's plain version, which the CUDA kernel's point-mass
instantiation is held to on the card) and a batched fixed-final-time
minimum-fuel sweep, run to convergence. Inputs are made with numpy from a
seed and handed to both packages; f64. The JAX side compiles one SCvx
iteration graph.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import pointmass3dof as jpm
from successiveconvexification_tpu.ops import scvx as jscvx
from successiveconvexification_tpu.ops.discretize import discretize as jdiscretize

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.ops import cuda_disc
from successiveconvexification_tpu_torch.ops.discretize import discretize as tdiscretize

K, SUBSTEPS = 8, 2
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _close(a, b, rtol, atol, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _params_np(seed, batch):
    """Dispersed point-mass params as numpy arrays (both packages read these):
    the main path's dispersion of r_init, v_init and the wet mass."""
    base = jpm.default_params(jnp.float64)
    rng = np.random.default_rng(seed)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (batch,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    d["r_init"] = d["r_init"] + 0.2 * rng.standard_normal((batch, 3))
    d["v_init"] = d["v_init"] + 0.1 * rng.standard_normal((batch, 3))
    d["m_wet"] = d["m_wet"] * (1.0 + 0.03 * rng.standard_normal(batch))
    return d


def _jparams(d):
    return jpm.PointMass3DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})


def _tparams(d):
    return tpm.params_from_numpy(d, device="cpu", dtype=F64)


def _states(rng, n):
    x = rng.standard_normal((n, tpm.NX))
    x[:, 0] = 1.5 + 0.2 * rng.random(n)
    return x, rng.standard_normal((n, tpm.NU))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


def test_default_params_initial_guess_and_packing():
    """The default scenario, the straight-line initial guess of a dispersed
    batch (f64 round-off) and the kernel's parameter packing
    (alpha_m, g_i)."""
    dj = jpm.default_params(jnp.float64)
    pt = tpm.default_params(F64)
    for f in dataclasses.fields(dj):
        _close(getattr(pt, f.name), getattr(dj, f.name), 1e-15, 0.0, f.name)
    d = _params_np(0, 3)
    Xj, Uj, sj = jax.vmap(lambda p: jpm.initial_guess(p, K))(_jparams(d))
    Xt, Ut, st = tpm.pointmass3dof_model().initial_guess(_tparams(d), K)
    _close(Xt, Xj, 1e-14, 1e-14, "X")
    _close(Ut, Uj, 1e-14, 1e-14, "U")
    _close(st, sj, 0.0, 0.0, "sigma")
    pk = tpm.kernel_params(_tparams(d))
    want = np.concatenate([d["alpha_m"][:, None], d["g_i"]], axis=1)
    np.testing.assert_array_equal(pk.numpy(), want)
    assert tpm.kernel_params(pt).shape == (4,)


def test_dynamics_and_jacobians():
    """f and its Jacobians (forward mode) against JAX's ``jax.jacfwd``, on
    random states of dispersed params; f64 round-off, 1e-12."""
    d = _params_np(1, 8)
    x, u = _states(np.random.default_rng(2), 8)
    mj, mt = jpm.pointmass3dof_model(), tpm.pointmass3dof_model()
    fj = jax.vmap(mj.f)(_jparams(d), jnp.asarray(x), jnp.asarray(u))
    Aj, Bj = jax.vmap(mj.jacobians)(_jparams(d), jnp.asarray(x), jnp.asarray(u))
    ft, At, Bt = mt.f_and_jacobians(_tparams(d), _t(x), _t(u))
    _close(ft, fj, 1e-12, 1e-12, "f")
    _close(At, Aj, 1e-12, 1e-12, "A")
    _close(Bt, Bj, 1e-12, 1e-12, "B")


def test_stage_cones():
    """Every linear row and SOC block (G and h) at random nodes."""
    d = _params_np(3, 6)
    x, u = _states(np.random.default_rng(4), 6)
    Gj, hj, socs_j = jax.vmap(jpm.stage_cones)(_jparams(d), jnp.asarray(x),
                                               jnp.asarray(u))
    Gt, ht, socs_t = tpm.stage_cones(_tparams(d), _t(x), _t(u))
    _close(Gt, Gj, 1e-14, 1e-14, "G_lin")
    _close(ht, hj, 1e-14, 1e-14, "h_lin")
    assert len(socs_t) == len(socs_j) == len(tpm.SOC_DIMS)
    for i, ((Gs, hs), (Gsj, hsj)) in enumerate(zip(socs_t, socs_j)):
        _close(Gs, Gsj, 1e-14, 1e-14, f"G_soc{i}")
        _close(hs, hsj, 1e-14, 1e-14, f"h_soc{i}")


@pytest.mark.parametrize("foh", [True, False], ids=["foh", "zoh"])
def test_plain_discretize_matches_jax(foh):
    """``discretize`` on CPU tensors (``discretize_lanes_plain``) against
    vmapped JAX ``discretize`` at K=8 on perturbed straight-line
    trajectories of B=3 dispersed scenarios; f64 round-off, 1e-10 of each
    output's largest entry. The kernel never launches on the CPU."""
    d = _params_np(5, 3)
    rng = np.random.default_rng(6)
    Xg, Ug, sg = jax.vmap(lambda p: jpm.initial_guess(p, K))(_jparams(d))
    X = np.asarray(Xg) + 0.05 * rng.standard_normal((3, K, tpm.NX))
    U = np.asarray(Ug) + 0.1 * rng.standard_normal((3, K, tpm.NU))
    sig = np.asarray(sg) * (1.0 + 0.1 * rng.standard_normal(3))
    mj, mt = jpm.pointmass3dof_model(), tpm.pointmass3dof_model()
    dj = jax.jit(jax.vmap(lambda p, x, uu, s: jdiscretize(
        mj, p, x, uu, s, substeps=SUBSTEPS, foh=foh)))(
            _jparams(d), jnp.asarray(X), jnp.asarray(U), jnp.asarray(sig))
    before = cuda_disc.discretize_lanes.launches
    dt = tdiscretize(mt, _tparams(d), _t(X), _t(U), _t(sig), substeps=SUBSTEPS,
                     foh=foh)
    assert cuda_disc.discretize_lanes.launches == before
    assert cuda_disc.kernel_dynamics(mt) == "pointmass3dof"
    for f in dt._fields:
        ref = np.asarray(getattr(dj, f))
        _close(getattr(dt, f), ref, 1e-10, 1e-10 * np.abs(ref).max(), f)


# ------------------------------------------------------------ the sweep
def _cfg_dict():
    """BASELINE config 1's problem: fixed final time, maximum final mass (the
    JAX package's ``test_min_fuel_fixed_time`` costs), Ruiz on every solve
    (ROADMAP Queue 3 says why)."""
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=K, substeps=SUBSTEPS),
        ipm=J.IPMConfig(equilibrate_cold_only=False),
        scvx=dataclasses.replace(J.ScvxConfig(), w_sigma=0.0, w_mass=1.0),
        free_final_time=False).to_dict()


@pytest.fixture(scope="module")
def sweep():
    """A B=2 sweep to convergence on both sides: JAX loops ONE jitted
    ``vmap(scvx_iteration)`` until no lane is alive (with Ruiz on every
    solve the general branch equals the all-warm one for valid carries);
    the port runs ``solve_batch``."""
    d = _params_np(7, 2)
    cfg_j = J.SolverConfig.from_dict(_cfg_dict())
    cfg_t = T.SolverConfig.from_dict(_cfg_dict())
    mj, mt = jpm.pointmass3dof_model(), tpm.pointmass3dof_model()
    pj = _jparams(d)
    sj = jax.jit(jax.vmap(lambda p: jscvx.scvx_init(mj, p, cfg_j)))(pj)
    step = jax.jit(jax.vmap(lambda p, s: jscvx.scvx_iteration(mj, p, cfg_j, s)))
    while np.any(~np.asarray(sj.converged)
                 & (np.asarray(sj.iterations) < cfg_j.scvx.max_iters)):
        sj = step(pj, sj)
    st = T.solve_batch(mt, _tparams(d), cfg_t, device="cpu")
    return sj, st, d


def test_sweep_counts_match_jax(sweep):
    """Both lanes converge, with identical iteration, accept, reject and
    penalty-bump counts; the final time stays pinned at tf_guess."""
    sj, st, d = sweep
    assert np.asarray(sj.converged).all()
    for f in ("converged", "iterations", "n_accept", "n_reject", "n_bump"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    np.testing.assert_array_equal(st.sigma.numpy(), d["tf_guess"])


def test_sweep_trajectories_match_jax(sweep):
    """The converged X and U agree to 1e-6 (the IPM stops at a relative
    gap of 1e-7 at the earliest, so two correct solves differ by about
    that), and the final mass beats the initial guess's."""
    sj, st, d = sweep
    _close(st.X, sj.X, 1e-6, 1e-6, "X")
    _close(st.U, sj.U, 1e-6, 1e-6, "U")
    assert bool((st.X[:, -1, 0] > _t(d["m_dry"])).all())
