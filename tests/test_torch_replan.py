"""The port's single-lane replanning path against the JAX package.

The replan path factors the KKT system without the fused kernel: the stage
Hessian through ``cuda_kkt.chol``, H^-1 E' and H^-1 F' through
``cuda_kkt.cho_solve`` (plain versions here, on the CPU), and the
block-tridiagonal Schur system by parallel cyclic reduction (PCR). Around it:
``discretize.condense`` / ``linear_rollout`` and ``scvx_warm_start``.

Every input is made with numpy from a seed and handed to both packages; f64,
K=6, B=2 wherever a batch axis is involved (a PCR shift along the wrong axis
mixes lanes, and only B > 1 shows it). Ruiz equilibration is on for every
solve (``equilibrate_cold_only=False``; ROADMAP Queue 3 says why).

The replan sequence runs with the static KKT regularization at 1e-6, not
the default 1e-8. At 1e-8 the PCR solve is not accurate enough late in an
f64 IPM: its residual stalls around 1e-4 to 1e-2 in both packages (PCR's
combined solution does not solve one nearby system), most subproblems end
on the stall exit, and which iterate a stalled IPM stops on is decided by
rounding. On this scenario the port and JAX agree to round-off until the
first stalled subproblem and part there, as do JAX's own ``scan`` and
``pcr`` routes; fed the same stalled subproblem, the two IPMs end on
different iterates (ROADMAP Queue 3; ``scripts/replan_diagnostic.py`` measures
it). At 1e-6 every subproblem of the sequence certifies, the ``pcr`` and
``scan`` routes give the same solution, and the comparison is determined.
The factorization and solve, and the replan path up to its first
uncertified subproblem, are compared at the default regularization.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.config import IPMConfig as JIPMConfig
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.ops import discretize as jdisc
from successiveconvexification_tpu.ops import ipm as jipm
from successiveconvexification_tpu.ops import pallas_kkt
from successiveconvexification_tpu.ops import scvx as jscvx
from successiveconvexification_tpu.ops import smallla as jla
from successiveconvexification_tpu.ops import socp as jsocp

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.config import IPMConfig
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.ops import cones as tC
from successiveconvexification_tpu_torch.ops import cuda_kkt
from successiveconvexification_tpu_torch.ops import discretize as tdisc
from successiveconvexification_tpu_torch.ops import ipm as tipm
from successiveconvexification_tpu_torch.ops import socp as tsocp
from successiveconvexification_tpu_torch.utils.tree import tree_map

K, B, SUBSTEPS = 6, 2, 2
F64 = torch.float64
# the bench's replan perturbation of r_init, and a second lane's
DR = np.array([[0.2, -0.2, 0.1], [-0.1, 0.15, 0.2]])
REPLAN_CAP = 40
# static KKT regularization of the replan-sequence tests (the default is
# 1e-8; the module docstring says why the sequence runs at 1e-6)
SEQ_REG = 1e-6


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _jnp_tree(tree):
    return tree_map(lambda a: jnp.asarray(_np(a)), tree)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


def _cfg_dict(static_reg):
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=K, substeps=SUBSTEPS),
        ipm=J.IPMConfig(kkt_solver="pcr", use_pallas=False,
                        equilibrate_cold_only=False,
                        static_reg=static_reg)).to_dict()


def _params_np():
    """The nominal (bench) scenario, unbatched, as numpy."""
    base = jrk.default_params(jnp.float64)
    return {f.name: np.asarray(getattr(base, f.name))
            for f in dataclasses.fields(base)}


def _replan_params_np():
    """The B=2 replan scenario: the nominal params with r_init moved by DR."""
    d = {k: np.broadcast_to(v, (B,) + v.shape).copy()
         for k, v in _params_np().items()}
    d["r_init"] = d["r_init"] + DR
    return d


def _jparams(d):
    return jrk.Rocket6DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})


def _tparams(d):
    return trk.params_from_numpy(d, device="cpu", dtype=F64)


# ------------------------------------------------- kernels' plain versions
def _spd_blocks(rng, N, n):
    A = rng.standard_normal((N, n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("n", [6, 17])
def test_chol_plain_matches_jax(n):
    """``chol_plain`` against JAX ``smallla.chol`` (the reference the Pallas
    chol is held to), both its LAPACK and its unrolled form: f64 round-off,
    rtol 1e-10. A block that is not positive definite comes out entirely
    non-finite in the port (the IPM masks lanes by finiteness)."""
    rng = np.random.default_rng(n)
    A = _spd_blocks(rng, B * K, n)
    A[3] -= (np.linalg.eigvalsh(A[3])[0] + 1.0) * np.eye(n)   # one non-PD block
    L = cuda_kkt.chol(_t(A))
    ok = np.arange(B * K) != 3
    for unrolled in (False, True):
        Lj = jla.chol(jnp.asarray(A), unrolled=unrolled)
        _close(_np(L)[ok], np.asarray(Lj)[ok], 1e-10, 1e-12, f"unrolled={unrolled}")
    assert not np.isfinite(_np(L)[3]).any()
    assert np.isfinite(_np(L)[ok]).all()


@pytest.mark.parametrize("n, m", [(6, 4), (17, 13)])
def test_cho_solve_plain_matches_jax(n, m):
    """``cho_solve_plain`` (matrix rhs) against JAX ``smallla.cho_solve``;
    f64 round-off, rtol 1e-10."""
    rng = np.random.default_rng(100 + n)
    L = np.linalg.cholesky(_spd_blocks(rng, B * (K - 1), n))
    R = rng.standard_normal((B * (K - 1), n, m))
    X = cuda_kkt.cho_solve(_t(L), _t(R))
    for unrolled in (False, True):
        Xj = jla.cho_solve(jnp.asarray(L), jnp.asarray(R), unrolled=unrolled)
        _close(X, Xj, 1e-10, 1e-12, f"unrolled={unrolled}")


def test_plain_versions_match_pallas_kernels_in_interpret_mode():
    """The TPU kernels themselves (``pallas_kkt.chol`` / ``cho_solve``, run in
    interpret mode on the CPU) against the plain versions the CUDA kernels
    are held to on the card; n=5, N=4, f64 round-off."""
    rng = np.random.default_rng(5)
    A = _spd_blocks(rng, 4, 5)
    R = rng.standard_normal((4, 5, 3))
    Lj = pallas_kkt.chol(jnp.asarray(A))
    Xj = pallas_kkt.cho_solve(Lj, jnp.asarray(R))
    L = cuda_kkt.chol(_t(A))
    _close(L, Lj, 1e-10, 1e-12, "chol")
    _close(cuda_kkt.cho_solve(L, _t(R)), Xj, 1e-10, 1e-12, "cho_solve")


# ------------------------------------------------------------------ the IPM
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


@pytest.fixture(scope="module")
def kkt_system():
    """One assembled B=2 rocket StageSOCP (port), a genuine NT scaling from
    random interior points, and a right-hand side, all seeded."""
    rng = np.random.default_rng(11)
    d = _replan_params_np()
    pt = _tparams(d)
    mt = trk.rocket6dof_model()
    X, U, sig = mt.initial_guess(pt, K)
    X = X + _t(0.05 * rng.standard_normal((B, K, trk.NX)))
    X = trk.project_state(X)
    U = U + _t(0.1 * rng.standard_normal((B, K, trk.NU)))
    disc = tdisc.discretize(mt, pt, X, U, sig, substeps=SUBSTEPS)
    dd = tsocp.assemble(mt, T.ScvxConfig(), pt, disc, X, U, sig,
                        _t([1.0, 0.3]), penalty_scale=_t([1.0, 10.0]))
    h = tsocp.cone_h(dd)
    spec = tipm._spec_of(dd)
    s = {k: _t(v) for k, v in _interior_np(h, rng).items()}
    z = {k: _t(v) for k, v in _interior_np(h, rng).items()}
    W = tC.nt_scaling(spec, s, z)
    x0 = tsocp.primal_zeros(dd)
    bx = tsocp.Primal(*(_t(rng.standard_normal(tuple(a.shape))) for a in x0))
    by = _t(rng.standard_normal(tuple(dd.b.shape)))
    bz = {k: _t(rng.standard_normal(tuple(v.shape))) for k, v in h.items()}
    return dd, W, bx, by, bz


def test_pcr_factorize_and_solve_match_jax(kkt_system):
    """Port ``factorize`` + ``solve_kkt_refined`` with ``kkt_solver="pcr"``
    against JAX's with ``IPMConfig(kkt_solver="pcr", use_pallas=False)`` on
    the same StageSOCP, scaling and rhs. Both run the same PCR recurrences
    in f64; the Hessian blocks and factors agree to round-off (rtol 1e-9),
    the refined solution to 1e-8 (the KKT system's conditioning)."""
    dd, W, bx, by, bz = kkt_system
    jcfg = JIPMConfig(kkt_solver="pcr", use_pallas=False)

    def one(d, w, x, y, z):
        f = jipm.factorize(d, w, jcfg)
        H = jipm.build_H(d, w, jcfg.static_reg)[0]
        return H, f, jipm.solve_kkt_refined(d, f, w, x, y, z, jcfg)

    dj = jsocp.StageSOCP(**{f: _jnp_tree(getattr(dd, f))
                            for f in jsocp.StageSOCP._fields})
    Hj, fj, (uxj, uyj, uzj) = jax.jit(jax.vmap(one))(
        dj, _jnp_tree(W), jsocp.Primal(*_jnp_tree(tuple(bx))), _jnp_tree(by),
        _jnp_tree(bz))
    cfg = IPMConfig(kkt_solver="pcr")
    H = tipm.build_H(dd, W, cfg.static_reg)[0]
    f = tipm.factorize(dd, W, cfg)
    ux, uy, uz = tipm.solve_kkt_refined(dd, f, W, bx, by, bz, cfg)
    _close(H, Hj, 1e-9, 1e-9 * float(np.abs(Hj).max()), "H")
    _close(f.chol_Hw, fj.chol_Hw, 1e-9, 1e-11, "chol_Hw")
    (levels, chol_final), (jlevels, jchol_final) = f.tri, fj.tri
    # JAX's vmap hands the levels' strides back broadcast over the lanes
    assert [s for _, _, s in levels] == [
        int(np.asarray(s).reshape(-1)[0]) for _, _, s in jlevels]
    for i, ((Ld, Cd, _), (jLd, jCd, _)) in enumerate(zip(levels, jlevels)):
        _close(Ld, jLd, 1e-9, 1e-11, f"level {i} chol_D")
        _close(Cd, jCd, 1e-9, 1e-11, f"level {i} C")
    _close(chol_final, jchol_final, 1e-9, 1e-11, "chol_final")
    _close(f.sm_t, fj.sm_t, 1e-9, 1e-11, "sm_t")
    _close(f.sm_denom, fj.sm_denom, 1e-9, 0.0, "sm_denom")
    for a, b_, name in ((ux.w, uxj.w, "ux.w"), (ux.sig, uxj.sig, "ux.sig"),
                        (uy, uyj, "uy")):
        _close(a, b_, 1e-8, 1e-8 * float(np.abs(b_).max()), name)
    for k in uz:
        _close(uz[k], uzj[k], 1e-8, 1e-8 * float(np.abs(uzj[k]).max()), k)


def test_pcr_route_matches_scan_route(kkt_system):
    """The port's two factorization routes solve the same KKT system: the
    refined solutions agree to 1e-8 of their scale (both are refined against
    the unregularized residual; PCR's combined solution is less accurate
    than the block Cholesky sweep's, so round-off is not the yardstick)."""
    dd, W, bx, by, bz = kkt_system
    out = []
    for kkt in ("pcr", "scan"):
        cfg = IPMConfig(kkt_solver=kkt)
        out.append(tipm.solve_kkt_refined(
            dd, tipm.factorize(dd, W, cfg), W, bx, by, bz, cfg))
    (uxp, uyp, _), (uxs, uys, _) = out
    for a, b_, name in ((uxp.w, uxs.w, "ux.w"), (uxp.sig, uxs.sig, "ux.sig"),
                        (uyp, uys, "uy")):
        _close(a, b_, 1e-8, 1e-8 * float(np.abs(_np(b_)).max()), name)


def test_unported_factorizations_raise(kkt_system):
    """``ksharded`` (multi-device) factors only over an installed mesh:
    without one it raises, and never falls back to another route
    (``tests/test_torch_ksharded.py`` holds the backend itself)."""
    dd, W, _, _, _ = kkt_system
    with pytest.raises(ValueError, match="set_kkt_mesh"):
        tipm.factorize(dd, W, IPMConfig(kkt_solver="ksharded"))


def test_scan_route_with_rank_one_rows_matches_pcr(kkt_system):
    """With a rank-one quadratic row a node (``Q_r1``) the ``scan`` route
    factors without the fused kernel, the Schur system by the block
    Cholesky (``cuda_kkt.tridiag_factor``), and solves the same KKT system
    as the ``pcr`` route: at static_reg 1e-6, where both certify (ROADMAP
    Queue 3), the refined solutions agree to 1e-8 of their scale."""
    dd, W, bx, by, bz = kkt_system
    rng = np.random.default_rng(31)
    nw = dd.c_w.shape[-1]
    d_r1 = dd._replace(Q_r1=_t(rng.standard_normal((B, K, 1, nw)))
                       * dd.free_w[:, :, None, :])
    out = []
    for kkt in ("pcr", "scan"):
        cfg = IPMConfig(kkt_solver=kkt, static_reg=1e-6)
        f = tipm.factorize(d_r1, W, cfg)
        out.append(tipm.solve_kkt_refined(d_r1, f, W, bx, by, bz, cfg))
    (uxp, uyp, uzp), (uxs, uys, uzs) = out
    for a, b_, name in ((uxp.w, uxs.w, "ux.w"), (uxp.sig, uxs.sig, "ux.sig"),
                        (uyp, uys, "uy")):
        _close(a, b_, 1e-8, 1e-8 * float(np.abs(_np(b_)).max()), name)
    for k in uzs:
        _close(uzp[k], uzs[k], 1e-8, 1e-8 * float(np.abs(_np(uzs[k])).max()), k)


# ------------------------------------------------------------- discretize
def test_condense_and_linear_rollout_match_jax():
    """Log-depth STM composition and the affine rollout, against JAX's
    ``associative_scan``; f64 round-off over a 5-interval product, rtol
    1e-10."""
    rng = np.random.default_rng(21)
    d = _replan_params_np()
    mt = trk.rocket6dof_model()
    pt = _tparams(d)
    X, U, sig = mt.initial_guess(pt, K)
    X = trk.project_state(X + _t(0.05 * rng.standard_normal((B, K, trk.NX))))
    U = U + _t(0.1 * rng.standard_normal((B, K, trk.NU)))
    sig = sig * _t(1.0 + 0.1 * rng.standard_normal(B))
    x0 = _t(rng.standard_normal((B, trk.NX)))
    disc = tdisc.discretize(mt, pt, X, U, sig, substeps=SUBSTEPS)
    disc_j = jdisc.Discretization(**{f: jnp.asarray(_np(getattr(disc, f)))
                                     for f in jdisc.Discretization._fields})
    Phi_j = jax.vmap(jdisc.condense)(disc_j)
    roll_j = jax.vmap(jdisc.linear_rollout)(disc_j, jnp.asarray(_np(x0)),
                                            jnp.asarray(_np(U)),
                                            jnp.asarray(_np(sig)))
    _close(tdisc.condense(disc), Phi_j, 1e-10, 1e-12, "condense")
    _close(tdisc.linear_rollout(disc, x0, U, sig), roll_j, 1e-10, 1e-12,
           "linear_rollout")


# --------------------------------------------------------- the replan path
@pytest.fixture(scope="module")
def replan():
    """JAX: a cold single-lane solve (a Python loop over the one jitted
    general-branch ``scvx_iteration``), then ``scvx_warm_start`` for each of
    the two perturbed lanes, then the replan iterations. Every state along
    the way is kept (numpy)."""
    cfg_j = J.SolverConfig.from_dict(_cfg_dict(SEQ_REG))
    mj = J.rocket6dof_model()
    step = jax.jit(lambda p, s: jscvx.scvx_iteration(mj, p, cfg_j, s))
    p0 = _jparams(_params_np())
    s = jax.jit(lambda p: jscvx.scvx_init(mj, p, cfg_j))(p0)
    cold = [jax.tree.map(np.asarray, s)]
    while not bool(s.converged) and int(s.iterations) < cfg_j.scvx.max_iters:
        s = step(p0, s)
        cold.append(jax.tree.map(np.asarray, s))
    warm_fn = jax.jit(lambda p, X, U, sg: jscvx.scvx_warm_start(
        mj, p, cfg_j, X, U, sg))
    lanes = []
    dr = _replan_params_np()
    for i in range(B):
        p = _jparams({k: v[i] for k, v in dr.items()})
        w = warm_fn(p, s.X, s.U, s.sigma)
        seq = [jax.tree.map(np.asarray, w)]
        while not bool(w.converged) and int(w.iterations) < REPLAN_CAP:
            w = step(p, w)
            seq.append(jax.tree.map(np.asarray, w))
        lanes.append(seq)
    return cold, lanes


def _stack(states):
    """Single-lane JAX states (numpy) -> one state with a batch axis."""
    return jax.tree.map(lambda *a: np.stack(a), *states)


def _check_state(st, ref, msg):
    """A port state (batch axis) against stacked JAX states: decisions and
    counters identical, the iterate to 1e-6 relative (the IPM stops at a
    relative gap of 1e-7, so two correct solves differ by about that)."""
    for f in ("converged", "accepted", "iterations", "n_accept", "n_reject",
              "n_bump"):
        np.testing.assert_array_equal(_np(getattr(st, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{msg}: {f}")
    np.testing.assert_array_equal(_np(torch.isfinite(st.ipm_carry.gap)),
                                  np.isfinite(ref.ipm_carry.gap),
                                  err_msg=f"{msg}: carry validity")
    _close(st.sigma, ref.sigma, 1e-6, 0.0, f"{msg}: sigma")
    _close(st.tr_radius, ref.tr_radius, 1e-6, 0.0, f"{msg}: tr_radius")
    _close(st.X, ref.X, 1e-6, 1e-6, f"{msg}: X")
    _close(st.U, ref.U, 1e-6, 1e-6, f"{msg}: U")


def test_warm_start_matches_jax(replan):
    """``scvx_warm_start`` from JAX's cold solution against JAX's, lane by
    lane: X, trust radius (the clipped defect default), merit terms and the
    IPM carry, to f64 round-off through one discretization and condense
    (rtol 1e-10). The per-lane and the broadcast (one nominal) forms of the
    previous solution give the same state."""
    cold, lanes = replan
    prev = cold[-1]
    cfg = T.SolverConfig.from_dict(_cfg_dict(SEQ_REG))
    mt = T.rocket6dof_model()
    pt = _tparams(_replan_params_np())
    w = T.scvx_warm_start(mt, pt, cfg, _t(prev.X), _t(prev.U), _t(prev.sigma))
    w_lanes = T.scvx_warm_start(mt, pt, cfg, _t(np.stack([prev.X] * B)),
                                _t(np.stack([prev.U] * B)),
                                _t(np.stack([prev.sigma] * B)))
    ref = _stack([seq[0] for seq in lanes])
    for f in ("X", "U", "sigma", "tr_radius", "obj_nl", "defect_nl", "viol_nl",
              "penalty_scale"):
        _close(getattr(w, f), getattr(ref, f), 1e-10, 1e-12, f)
        torch.testing.assert_close(getattr(w_lanes, f), getattr(w, f),
                                   rtol=0, atol=0, msg=f)
    for f in ("converged", "iterations", "accepted"):
        np.testing.assert_array_equal(_np(getattr(w, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    jl = jax.tree.leaves(ref.ipm_carry)
    tl = jax.tree.leaves(tree_map(_np, w.ipm_carry))
    assert len(jl) == len(tl)
    for i, (a, b_) in enumerate(zip(tl, jl)):
        np.testing.assert_array_equal(a, b_, err_msg=f"carry leaf {i}")


def test_one_iteration_from_jax_warm_start(replan):
    """A JAX warm-started state carried into the port (``state_from_numpy``)
    and advanced one port iteration gives JAX's next state, both lanes."""
    _, lanes = replan
    cfg = T.SolverConfig.from_dict(_cfg_dict(SEQ_REG))
    st = trk.state_from_numpy(_stack([seq[0] for seq in lanes]))
    out = T.scvx_iteration(T.rocket6dof_model(), _tparams(_replan_params_np()),
                           cfg, st)
    _check_state(out, _stack([seq[1] for seq in lanes]), "first replan step")


def test_replan_sequence_matches_jax(replan):
    """The port's own replan sequence (``scvx_solve``, ``scvx_warm_start``
    from the one nominal solution broadcast over both lanes, then up to
    REPLAN_CAP general-branch iterations of the B=2 batch) against JAX's:
    identical iteration counts, accept/reject counts and converged flags;
    sigma to 1e-6 relative."""
    cold, lanes = replan
    cfg = T.SolverConfig.from_dict(_cfg_dict(SEQ_REG))
    mt = T.rocket6dof_model()
    st = T.scvx_solve(mt, trk.default_params(F64), cfg, device="cpu")
    _check_state(st, _stack([cold[-1]]), "cold solve")
    assert bool(st.converged.all())
    pt = _tparams(_replan_params_np())
    w = T.scvx_warm_start(mt, pt, cfg, st.X[0], st.U[0], st.sigma[0])
    for _ in range(REPLAN_CAP):
        if bool(w.converged.all()):
            break
        w = T.scvx_iteration(mt, pt, cfg, w)
    _check_state(w, _stack([seq[-1] for seq in lanes]), "replan")
    assert bool(w.converged.all())


# ------------------------------------- the replan path at the default 1e-8
@pytest.fixture(scope="module")
def default_reg_cold():
    """JAX at the default static regularization (1e-8): the cold loop of the
    ``replan`` fixture, every state kept (numpy), and both lanes' warm
    starts from its solution."""
    cfg_j = J.SolverConfig.from_dict(_cfg_dict(1e-8))
    mj = J.rocket6dof_model()
    step = jax.jit(lambda p, s: jscvx.scvx_iteration(mj, p, cfg_j, s))
    p0 = _jparams(_params_np())
    s = jax.jit(lambda p: jscvx.scvx_init(mj, p, cfg_j))(p0)
    cold = [jax.tree.map(np.asarray, s)]
    while not bool(s.converged) and int(s.iterations) < cfg_j.scvx.max_iters:
        s = step(p0, s)
        cold.append(jax.tree.map(np.asarray, s))
    warm_fn = jax.jit(lambda p, X, U, sg: jscvx.scvx_warm_start(
        mj, p, cfg_j, X, U, sg))
    dr = _replan_params_np()
    warm = [jax.tree.map(np.asarray, warm_fn(
        _jparams({k: v[i] for k, v in dr.items()}), s.X, s.U, s.sigma))
        for i in range(B)]
    return cold, warm


def test_replan_prefix_matches_jax_at_default_reg(default_reg_cold):
    """At the shipped static_reg 1e-8 the port and JAX agree until the
    first subproblem whose IPM does not certify; from there rounding decides
    (module docstring). Held here: the port's
    own cold loop (general-branch ``scvx_iteration`` from ``scvx_init``, as
    JAX's) against JAX's over that prefix, every state by ``_check_state``
    (decisions and counters identical, the iterate to 1e-6); and
    ``scvx_warm_start`` from JAX's cold solution against JAX's for both
    moved lanes (rtol 1e-10, as ``test_warm_start_matches_jax``)."""
    cold, warm = default_reg_cold
    certified = [bool(s.ipm_carry.converged) for s in cold[1:]]
    prefix = certified.index(False) if False in certified else len(certified)
    assert prefix >= 2, f"JAX certified only {prefix} leading subproblems"
    cfg = T.SolverConfig.from_dict(_cfg_dict(1e-8))
    mt = T.rocket6dof_model()
    p0 = trk.default_params(F64)
    st = T.scvx_init(mt, p0.map(lambda v, tail: v[None]), cfg)
    for i in range(prefix):
        st = T.scvx_iteration(mt, p0.map(lambda v, tail: v[None]), cfg, st)
        _check_state(st, _stack([cold[i + 1]]), f"cold iteration {i + 1}")
        assert bool(st.ipm_carry.converged.all())
    prev = cold[-1]
    w = T.scvx_warm_start(mt, _tparams(_replan_params_np()), cfg,
                          _t(prev.X), _t(prev.U), _t(prev.sigma))
    ref = _stack(warm)
    for f in ("X", "U", "sigma", "tr_radius", "obj_nl", "defect_nl", "viol_nl"):
        _close(getattr(w, f), getattr(ref, f), 1e-10, 1e-12, f)
