"""The port's angle-of-attack STC variant and IPM status code against JAX.

``rocket6dof_model(aoa_stc=True)`` adds the linearized state-triggered
constraint h(x) = -min(v_trigger - ||v||, 0) (cos(alpha_max) ||v|| +
e1 . C_BI v) <= 0 as a third linear row of every node. JAX takes the row's
gradient with ``jax.grad`` per node; the port with one batched pullback
(``torch.func.vjp``), which must give the same value at the trigger's kink
(d min(g, 0)/dg = 0.5 at g = 0) and at v = 0 (safe_norm's epsilon).

Every input is made with numpy from a seed and handed to both packages; f64.
The JAX side compiles one SCvx iteration graph.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.ops import ipm as jipm
from successiveconvexification_tpu.ops import scvx as jscvx

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.ops import ipm as tipm

F64 = torch.float64
K, B, SUBSTEPS, ITERS = 6, 2, 4, 4


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


def _states(seed=0, n=64):
    """n states (m, v, q random; r, omega 0) and controls, in four groups of
    speeds: below the trigger (1.5), at it (|v| = 1.5 for half the group,
    and for the other half safe_norm(v) == 1.5 exactly, the trigger's kink
    g = 0), above it, and v = 0; random unit quaternions."""
    rng = np.random.default_rng(seed)
    g = n // 4
    X = np.zeros((n, jrk.NX))
    X[:, 0] = 1.0 + rng.random(n)
    q = rng.standard_normal((n, 4))
    X[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    speed = np.concatenate([rng.uniform(0.1, 1.4, g), np.full(g, 1.5),
                            rng.uniform(1.6, 4.0, g), np.zeros(n - 3 * g)])
    X[:, 4:7] = d * speed[:, None]
    kink = []
    while len(kink) < g // 2:    # directions at which the rounding lands on 1.5
        v = rng.standard_normal(3)
        v *= np.sqrt(2.25 - 1e-12) / np.linalg.norm(v)
        if np.sqrt(np.sum(v * v) + 1e-12) == 1.5:
            kink.append(v)
    X[g:g + g // 2, 4:7] = kink
    U = rng.standard_normal((n, jrk.NU))
    return X, U, slice(g, g + g // 2)


def test_stc_scalar_and_row_match_jax():
    """``_aoa_stc_scalar`` and ``_aoa_stc_row`` against JAX's (vmapped over
    the states) on 64 states in every region of the trigger, f64, rtol
    1e-12; the kink states have g = 0 exactly on both sides."""
    X, U, kink = _states()
    jp, tp = jrk.default_params(jnp.float64), trk.default_params(F64)
    xj, uj = jnp.asarray(X), jnp.asarray(U)
    h_j = jax.vmap(lambda x, u: jrk._aoa_stc_scalar(jp, x, u))(xj, uj)
    G_j, r_j = jax.vmap(lambda x, u: jrk._aoa_stc_row(jp, x, u))(xj, uj)
    xt, ut = torch.tensor(X), torch.tensor(U)
    h_t = trk._aoa_stc_scalar(tp, xt, ut)
    with torch.no_grad():     # the pullback needs no autograd context
        G_t, r_t = trk._aoa_stc_row(tp, xt, ut)
    assert tuple(G_t.shape) == (64, 1, 17) and tuple(r_t.shape) == (64, 1)
    speed = np.sqrt(np.sum(X[kink, 4:7] ** 2, axis=1) + 1e-12)
    assert np.all(1.5 - speed == 0.0)
    np.testing.assert_allclose(_np(h_t), np.asarray(h_j), rtol=1e-12, atol=0)
    np.testing.assert_allclose(_np(G_t), np.asarray(G_j), rtol=1e-12, atol=0)
    np.testing.assert_allclose(_np(r_t), np.asarray(r_j), rtol=1e-12, atol=0)
    # at the kink the gradient is half the one-sided one, 0.5 c v / ||v||
    c = (float(tp.cos_aoa_max) * speed
         + np.sum(_np(trk.quat_to_dcm(xt[kink, 7:11]))[:, :, 0] * X[kink, 4:7],
                  axis=1))
    np.testing.assert_allclose(_np(G_t)[kink, 0, 4:7],
                               0.5 * c[:, None] * X[kink, 4:7] / speed[:, None],
                               rtol=1e-12)


def test_stc_row_is_strictly_interior_when_off():
    """Below the trigger speed and at v = 0 the row is 0'd <= eps: G zero,
    h > 0 (the JAX package's ``test_stc_row_is_strictly_interior_when_off``),
    on a batch of nodes at once."""
    X, U, _ = _states(1)
    off = np.concatenate([np.arange(16), np.arange(48, 64)])
    G, h = trk._aoa_stc_row(trk.default_params(F64), torch.tensor(X[off]),
                            torch.tensor(U[off]))
    np.testing.assert_allclose(_np(G), 0.0, atol=1e-12)
    assert np.all(_np(h) > 0.0)


def test_stc_model_variant_shapes():
    """The variant: name, n_lin + 1, one cached instance per flag, three
    linear rows per node over (B, K) leading axes, the vacuum model's cones."""
    m0, m1 = trk.rocket6dof_model(), trk.rocket6dof_model(aoa_stc=True)
    assert m1.name == "rocket6dof_stc" and m0.name == "rocket6dof"
    assert m1.n_lin == m0.n_lin + 1 == 3
    assert m1 is trk.rocket6dof_model(aoa_stc=True)
    assert m0 is trk.rocket6dof_model(aoa_stc=False) is T.rocket6dof_model()
    X, U, _ = _states(2, 12)
    p = trk.default_params(F64).map(lambda v, tail: v.expand((2,) + v.shape))
    G, h, socs = m1.stage_cones(p.unsqueeze(1), torch.tensor(X).reshape(2, 6, -1),
                                torch.tensor(U).reshape(2, 6, -1))
    G0, h0, socs0 = m0.stage_cones(p.unsqueeze(1),
                                   torch.tensor(X).reshape(2, 6, -1),
                                   torch.tensor(U).reshape(2, 6, -1))
    assert tuple(G.shape) == (2, 6, 3, 17) and tuple(h.shape) == (2, 6, 3)
    assert torch.equal(G[..., :2, :], G0) and torch.equal(h[..., :2], h0)
    assert len(socs) == len(m0.soc_dims)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(socs, socs0))


def test_status_matches_jax():
    """``ipm.status`` against JAX's on all 16 combinations of the four
    flags, and the same STATUS_* values."""
    for name in ("RUNNING", "OPTIMAL", "STALLED", "PRIM_INFEAS", "DUAL_INFEAS"):
        assert getattr(tipm, f"STATUS_{name}") == getattr(jipm, f"STATUS_{name}")
    flags = np.array(list(itertools.product([False, True], repeat=4)))
    conv, stall, prim, dual = flags.T
    st_t = tipm.IPMState(None, None, None, None, torch.tensor(conv), None,
                         None, None, None, torch.tensor(stall),
                         torch.tensor(prim), torch.tensor(dual))
    st_j = jipm.IPMState(None, None, None, None, jnp.asarray(conv), None,
                         None, None, None, jnp.asarray(stall),
                         jnp.asarray(prim), jnp.asarray(dual))
    code = tipm.status(st_t)
    assert code.dtype == torch.int32
    np.testing.assert_array_equal(_np(code), np.asarray(jipm.status(st_j)))


# --------------------------------------------------------- SCvx iterations
def _params_np(seed):
    """B=2 dispersions of the default scenario; lane 1 with drag."""
    base = jrk.default_params(jnp.float64)
    rng = np.random.default_rng(seed)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (B,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    d["r_init"] = d["r_init"] + 0.2 * rng.standard_normal((B, 3))
    d["v_init"] = d["v_init"] + 0.1 * rng.standard_normal((B, 3))
    d["m_wet"] = d["m_wet"] * (1.0 + 0.03 * rng.standard_normal(B))
    d["cd_a"] = np.array([0.0, 0.05])
    return d


@pytest.fixture(scope="module")
def iterations():
    """ITERS batched SCvx iterations of the STC model from ``scvx_init`` on
    both sides (the first subproblem cold, the others warm); Ruiz on every
    solve, as the f64 comparisons run (ROADMAP Queue 3)."""
    d = _params_np(5)
    cfg_d = J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=K, substeps=SUBSTEPS),
        ipm=J.IPMConfig(equilibrate_cold_only=False)).to_dict()
    cfg_j, cfg_t = J.SolverConfig.from_dict(cfg_d), T.SolverConfig.from_dict(cfg_d)
    mj, mt = jrk.rocket6dof_model(aoa_stc=True), trk.rocket6dof_model(aoa_stc=True)
    pj = jrk.Rocket6DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})
    pt = trk.params_from_numpy(d, device="cpu", dtype=F64)
    sj = [jax.jit(jax.vmap(lambda p: jscvx.scvx_init(mj, p, cfg_j)))(pj)]
    st = [T.scvx_init(mt, pt, cfg_t)]
    step = jax.jit(jax.vmap(lambda p, s: jscvx.scvx_iteration(mj, p, cfg_j, s)))
    for _ in range(ITERS):
        sj.append(step(pj, sj[-1]))
        st.append(T.scvx_iteration(mt, pt, cfg_t, st[-1]))
    return pt, sj, st


def test_trigger_is_on_at_some_nodes(iterations):
    """The scenario exercises the row: above the trigger speed at some
    nodes of both lanes, below it at others, at the start and at the end."""
    pt, _, st = iterations
    for s in (st[0], st[-1]):
        speed = torch.linalg.vector_norm(s.X[..., 4:7], dim=-1)
        on = speed > pt.v_trigger[:, None]
        assert bool(on.any(1).all()) and bool((~on).any(1).all())


@pytest.mark.parametrize("it", range(1, ITERS + 1))
def test_stc_iteration_matches_jax(iterations, it):
    """Each iteration's iterate, accept/reject decisions and IPM counts
    agree with JAX's ``vmap(scvx_iteration)``, lane 0 in vacuum and lane 1
    with drag (cd_a 0.05): X, U, sigma at rtol 1e-8, the flags and counts
    identical."""
    _, sj, st = iterations
    a, b = st[it], sj[it]
    for f in ("X", "U", "sigma"):
        np.testing.assert_allclose(_np(getattr(a, f)), np.asarray(getattr(b, f)),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    for f in ("accepted", "converged", "n_accept", "n_reject", "n_bump",
              "iterations", "ipm_iters"):
        np.testing.assert_array_equal(_np(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
