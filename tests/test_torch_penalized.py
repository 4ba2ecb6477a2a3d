"""The port's penalized-direction path against the JAX package, on the CPU.

A model with ``penalized_dirs`` gives the subproblem rank-one quadratic rows
(``Q_r1``), and with ``kkt_solver="scan"`` both packages then factor the KKT
system without the fused kernel: the stage Hessian block by block, the
Schur system M = A H^-1 A' by the block-tridiagonal Cholesky
(``cuda_kkt.tridiag_factor`` in the port, ``pallas_kkt.tridiag_factor`` or
``smallla.blocktridiag_factor`` in the JAX package). The model is the
rocket with one penalized direction a node, the unit thrust direction
(0_nx, u/|u|): a soft limit on throttle moves between iterates.

Every input is made with numpy from a seed and handed to both packages;
f64, K=6, B=2 (B=3 for the factor kernel's plain version). The JAX side
compiles one SCvx iteration graph.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.config import IPMConfig as JIPMConfig
from successiveconvexification_tpu.config import ScvxConfig as JScvxConfig
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.models.base import safe_norm as jsafe_norm
from successiveconvexification_tpu.ops import cones as jC
from successiveconvexification_tpu.ops import equilibrate as jeq
from successiveconvexification_tpu.ops import ipm as jipm
from successiveconvexification_tpu.ops import pallas_kkt
from successiveconvexification_tpu.ops import scvx as jscvx
from successiveconvexification_tpu.ops import smallla as jla
from successiveconvexification_tpu.ops import socp as jsocp
from successiveconvexification_tpu.ops.discretize import discretize as jdiscretize

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.config import IPMConfig, ScvxConfig
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.models.base import safe_norm as tsafe_norm
from successiveconvexification_tpu_torch.ops import cones as tC
from successiveconvexification_tpu_torch.ops import cuda_kkt
from successiveconvexification_tpu_torch.ops import equilibrate as teq
from successiveconvexification_tpu_torch.ops import ipm as tipm
from successiveconvexification_tpu_torch.ops import socp as tsocp
from successiveconvexification_tpu_torch.ops.discretize import discretize as tdiscretize
from successiveconvexification_tpu_torch.utils.tree import tree_map

K, B, SUBSTEPS = 6, 2, 2
F64 = torch.float64
W_DIR = 1.0       # w_dir_penalty of the subproblems below


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _jnp_tree(tree):
    return tree_map(lambda a: jnp.asarray(_np(a)), tree)


def _jdirs(params, xk, uk):
    """(1, nx+nu): the unit thrust direction at one node (JAX model)."""
    return jnp.concatenate([jnp.zeros_like(xk), uk / jsafe_norm(uk)])[None]


def _tdirs(params, xk, uk):
    """(..., 1, nx+nu): the same rows, batched over nodes (port model)."""
    n = uk / tsafe_norm(uk)[..., None]
    return torch.cat([torch.zeros_like(xk), n], dim=-1)[..., None, :]


def _jmodel():
    return dataclasses.replace(jrk.rocket6dof_model(),
                               name="rocket6dof_throttle", penalized_dirs=_jdirs)


def _tmodel():
    return dataclasses.replace(trk.rocket6dof_model(),
                               name="rocket6dof_throttle", penalized_dirs=_tdirs)


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


def _jparams(d):
    return jrk.Rocket6DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})


def _tparams(d):
    return trk.params_from_numpy(d, device="cpu", dtype=F64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


# -------------------------------------------------------- the subproblem
@pytest.fixture(scope="module")
def problems():
    """Perturbed straight-line trajectories of a dispersed B=2 batch,
    discretized and assembled with the penalized model on both sides, and
    their Ruiz equilibration."""
    d = _params_np(3, B)
    rng = np.random.default_rng(4)
    X, U, sig = jax.vmap(lambda p: jrk.initial_guess(p, K))(_jparams(d))
    X = np.asarray(X) + 0.05 * rng.standard_normal((B, K, jrk.NX))
    X[..., 7:11] /= np.linalg.norm(X[..., 7:11], axis=-1, keepdims=True)
    U = np.asarray(U) + 0.1 * rng.standard_normal((B, K, jrk.NU))
    sig = np.asarray(sig)
    tr = np.array([1.0, 0.3])
    pscale = np.array([1.0, 10.0])
    mj, mt = _jmodel(), _tmodel()
    cfg = dataclasses.replace(JScvxConfig(), w_dir_penalty=W_DIR)

    def jone(p, x, u, s, r, ps):
        disc = jdiscretize(mj, p, x, u, s, substeps=SUBSTEPS)
        dd = jsocp.assemble(mj, cfg, p, disc, x, u, s, r, free_final_time=True,
                            penalty_scale=ps)
        return dd, jeq.equilibrate(dd, iters=3)

    d_j, eq_j = jax.jit(jax.vmap(jone))(
        _jparams(d), jnp.asarray(X), jnp.asarray(U), jnp.asarray(sig),
        jnp.asarray(tr), jnp.asarray(pscale))
    pt = _tparams(d)
    disc_t = tdiscretize(mt, pt, _t(X), _t(U), _t(sig), substeps=SUBSTEPS)
    d_t = tsocp.assemble(mt, dataclasses.replace(ScvxConfig(), w_dir_penalty=W_DIR),
                         pt, disc_t, _t(X), _t(U), _t(sig), _t(tr),
                         free_final_time=True, penalty_scale=_t(pscale))
    return (d_j, eq_j), (d_t, teq.equilibrate(d_t, iters=3))


def test_q_r1_matches_jax(problems):
    """``socp.assemble``'s rank-one rows (the direction through the tangent
    basis, the zero t column, sqrt(w_dir_penalty), the pins) and their Ruiz
    scaling against JAX's: f64 round-off, rtol 1e-10. One row a node, zero
    where the pins hold (the terminal node's thrust is free)."""
    (d_j, eq_j), (d_t, eq_t) = problems
    nw = d_t.c_w.shape[-1]
    assert tuple(d_t.Q_r1.shape) == (B, K, 1, nw)
    _close(d_t.Q_r1, d_j.Q_r1, 1e-10, 1e-12, "Q_r1")
    _close(eq_t[0].Q_r1, eq_j[0].Q_r1, 1e-10, 1e-12, "equilibrated Q_r1")
    # the rows are the unit thrust directions, scaled by sqrt(W_DIR)
    q = _np(d_t.Q_r1)[..., 0, :]
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), np.sqrt(W_DIR),
                               rtol=1e-6)
    for f in ("E", "G_lin", "c_w", "Q_w"):
        _close(getattr(d_t, f), getattr(d_j, f), 1e-10, 1e-12, f)


# ------------------------------------------- the factor kernel's plain version
def _random_btd(rng, batch, N, n):
    """A random well-conditioned SPD block-tridiagonal (D, O) batch (the
    JAX package's ``tests/test_pallas_kkt.py`` recipe)."""
    A = rng.normal(size=(batch * N, n, n))
    D = (A @ np.swapaxes(A, 1, 2) + 5 * np.eye(n)).reshape(batch, N, n, n) \
        + 4.0 * n * np.eye(n)
    return D, 0.5 * rng.normal(size=(batch, N - 1, n, n))


def test_tridiag_factor_plain_matches_pallas_and_smallla():
    """``cuda_kkt.tridiag_factor`` on CPU tensors (its plain version, which
    the CUDA kernel is held to on the card) against the TPU kernel itself,
    ``jax.vmap(pallas_kkt.tridiag_factor)`` run in interpret mode on the
    CPU as the JAX package's own tests run it, and against JAX's
    ``smallla.blocktridiag_factor``; B=3, N=13, n=7, f64 round-off, rtol
    1e-10."""
    rng = np.random.default_rng(12)
    D, O = _random_btd(rng, 3, 13, 7)
    L, C = cuda_kkt.tridiag_factor(_t(D), _t(O))
    assert cuda_kkt.tridiag_factor.launches == 0
    Lp, Cp = jax.vmap(pallas_kkt.tridiag_factor)(jnp.asarray(D), jnp.asarray(O))
    Ls, Cs = jax.vmap(jla.blocktridiag_factor)(jnp.asarray(D), jnp.asarray(O))
    for (Lj, Cj), who in (((Lp, Cp), "pallas"), ((Ls, Cs), "smallla")):
        _close(L, Lj, 1e-10, 1e-12, f"L vs {who}")
        _close(C, Cj, 1e-10, 1e-12, f"C vs {who}")
    assert np.all(_np(C)[:, 0] == 0.0)


def test_tridiag_factor_breakdown_poisons_the_rest_of_the_lane():
    """A block that is not positive definite comes out NaN, and so does
    every later block of its lane (the IPM's stall exit relies on it); the
    blocks before it and the other lanes are untouched."""
    rng = np.random.default_rng(13)
    D, O = _random_btd(rng, 2, 6, 4)
    good_L, good_C = cuda_kkt.tridiag_factor(_t(D), _t(O))
    D[1, 3] -= (np.linalg.eigvalsh(D[1, 3])[0] + 50.0) * np.eye(4)
    L, C = (_np(a) for a in cuda_kkt.tridiag_factor(_t(D), _t(O)))
    assert np.isnan(L[1, 3:]).all() and np.isnan(C[1, 4:]).all()
    np.testing.assert_array_equal(L[1, :3], _np(good_L)[1, :3])
    np.testing.assert_array_equal(C[1, :4], _np(good_C)[1, :4])
    np.testing.assert_array_equal(L[0], _np(good_L)[0])


# ------------------------------------------------------- the unfused scan route
def _interior_np(h, rng):
    """Random strictly interior cone points shaped like cone_h (numpy)."""
    out = {}
    for k, v in h.items():
        v = _np(v)
        if k in ("lin", "pq", "sig"):
            out[k] = 1.0 + 0.3 * rng.random(v.shape)
        else:
            p = np.zeros(v.shape)
            p[..., 1:] = 0.3 * rng.standard_normal(v.shape[:-1] + (v.shape[-1] - 1,))
            p[..., 0] = np.linalg.norm(p[..., 1:], axis=-1) + 0.3 + rng.random(v.shape[:-1])
            out[k] = p
    return out


def test_unfused_scan_factorize_and_solve_match_jax(problems):
    """Port ``factorize`` + ``solve_kkt_refined`` with ``kkt_solver="scan"``
    on the penalized subproblem (so the unfused route: H with Q_r1'Q_r1,
    chol, the matrix solves, D and O, the block-tridiagonal factor and the
    Sherman-Morrison data) against JAX's with ``IPMConfig(use_pallas=False)``
    (the XLA form of the factor kernel's contract), at a genuine NT scaling
    from random interior points and a random right-hand side. Factors and
    solutions agree to f64 round-off: rtol 1e-10 (of each array's largest
    entry for the solutions)."""
    (d_j, _), (d_t, _) = problems
    rng = np.random.default_rng(6)
    h = tsocp.cone_h(d_t)
    spec = tipm._spec_of(d_t)
    s = {k: _t(v) for k, v in _interior_np(h, rng).items()}
    z = {k: _t(v) for k, v in _interior_np(h, rng).items()}
    W = tC.nt_scaling(spec, s, z)
    x0 = tsocp.primal_zeros(d_t)
    bx = tsocp.Primal(*(_t(rng.standard_normal(tuple(a.shape))) for a in x0))
    by = _t(rng.standard_normal(tuple(d_t.b.shape)))
    bz = {k: _t(rng.standard_normal(tuple(v.shape))) for k, v in h.items()}
    jcfg = JIPMConfig(use_pallas=False)

    def one(d, ss, zs, x, y, zz):
        w = jC.nt_scaling(spec, ss, zs)
        f = jipm.factorize(d, w, jcfg)
        return f, jipm.solve_kkt_refined(d, f, w, x, y, zz, jcfg)

    fj, (uxj, uyj, uzj) = jax.jit(jax.vmap(one))(
        d_j, _jnp_tree(s), _jnp_tree(z), jsocp.Primal(*_jnp_tree(tuple(bx))),
        _jnp_tree(by), _jnp_tree(bz))
    cfg = IPMConfig()
    before = cuda_kkt.tridiag_factor.launches
    f = tipm.factorize(d_t, W, cfg)
    ux, uy, uz = tipm.solve_kkt_refined(d_t, f, W, bx, by, bz, cfg)
    assert cuda_kkt.tridiag_factor.launches == before   # plain on the CPU
    _close(f.chol_Hw, fj.chol_Hw, 1e-10, 1e-12, "chol_Hw")
    _close(f.tri[0], fj.tri[0], 1e-10, 1e-12, "L")
    _close(f.tri[1], fj.tri[1], 1e-10, 1e-12, "C")
    _close(f.sm_t, fj.sm_t, 1e-10, 1e-12, "sm_t")
    _close(f.sm_denom, fj.sm_denom, 1e-10, 0.0, "sm_denom")
    for a, b_, name in ((ux.w, uxj.w, "ux.w"), (ux.sig, uxj.sig, "ux.sig"),
                        (uy, uyj, "uy")):
        _close(a, b_, 1e-10, 1e-10 * float(np.abs(_np(b_)).max()), name)
    for k in uz:
        _close(uz[k], uzj[k], 1e-10, 1e-10 * float(np.abs(_np(uzj[k])).max()), k)


# --------------------------------------------------------- SCvx iterations
def _cfg_dict():
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=K, substeps=SUBSTEPS),
        ipm=J.IPMConfig(equilibrate_cold_only=False),
        scvx=dataclasses.replace(J.ScvxConfig(), tr_mode="soft",
                                 w_dir_penalty=W_DIR)).to_dict()


@pytest.fixture(scope="module")
def iterations():
    """Two batched soft-trust-region SCvx iterations of the penalized model
    from ``scvx_init`` (a cold first subproblem, a warm second) on both
    sides; the JAX side compiles ``vmap(scvx_iteration)`` once."""
    d = _params_np(8, B)
    cfg_j = J.SolverConfig.from_dict(_cfg_dict())
    cfg_t = T.SolverConfig.from_dict(_cfg_dict())
    mj, mt = _jmodel(), _tmodel()
    pj, pt = _jparams(d), _tparams(d)
    sj = [jax.jit(jax.vmap(lambda p: jscvx.scvx_init(mj, p, cfg_j)))(pj)]
    st = [T.scvx_init(mt, pt, cfg_t)]
    step = jax.jit(jax.vmap(lambda p, s: jscvx.scvx_iteration(mj, p, cfg_j, s)))
    for _ in range(2):
        sj.append(step(pj, sj[-1]))
        st.append(T.scvx_iteration(mt, pt, cfg_t, st[-1]))
    return sj, st


@pytest.mark.parametrize("it", [1, 2])
def test_soft_trust_region_iteration_matches_jax(iterations, it):
    """Each iteration's iterate, accept/reject decisions and IPM counts
    agree with JAX's, and so do the predicted decrease and rho: the
    predicted cost of a soft trust-region step includes the penalized
    directions' quadratic, 0.5 sum_k sum_i (Q_r1[k,i] . w_k)^2. f64; the
    IPM stops at a relative gap of 1e-7 at the earliest, so the iterates
    agree to 1e-8 relative."""
    sj, st = iterations
    a, b = st[it], sj[it]
    assert np.all(np.isfinite(_np(b.pred_dec)))
    for f in ("X", "U", "sigma", "tr_radius", "pred_dec", "rho"):
        _close(getattr(a, f), getattr(b, f), 1e-8, 1e-8, f)
    for f in ("accepted", "converged", "n_accept", "n_reject", "n_bump",
              "iterations", "ipm_iters"):
        np.testing.assert_array_equal(_np(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
