"""The port's modules and its kernels' plain versions against the JAX package.

Every input is made with numpy from a seed (or computed by the JAX package
from such inputs) and handed to both packages as numpy arrays; f64, small
sizes (K=6, B=3). On the CPU the kernel wrappers run their plain PyTorch
versions, which are what the CUDA kernels are held to on the card
(``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from successiveconvexification_tpu.config import IPMConfig as JIPMConfig
from successiveconvexification_tpu.config import ScvxConfig as JScvxConfig
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.ops import cones as jC
from successiveconvexification_tpu.ops import equilibrate as jeq
from successiveconvexification_tpu.ops import ipm as jipm
from successiveconvexification_tpu.ops import pallas_fused, pallas_kkt
from successiveconvexification_tpu.ops import smallla as jla
from successiveconvexification_tpu.ops import socp as jsocp
from successiveconvexification_tpu.ops.discretize import discretize as jdiscretize

from successiveconvexification_tpu_torch.config import IPMConfig, ScvxConfig
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.ops import cones as tC
from successiveconvexification_tpu_torch.ops import cuda_fused, cuda_kkt
from successiveconvexification_tpu_torch.ops import equilibrate as teq
from successiveconvexification_tpu_torch.ops import ipm as tipm
from successiveconvexification_tpu_torch.ops import smallla as tla
from successiveconvexification_tpu_torch.ops import socp as tsocp
from successiveconvexification_tpu_torch.ops.discretize import discretize as tdiscretize

K, B, SUBSTEPS = 6, 3, 2
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol, atol=None, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol,
                               atol=rtol * 1e-2 if atol is None else atol,
                               err_msg=msg)


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


def _trajectories(seed):
    """Perturbed straight-line trajectories (numpy) for a dispersed batch."""
    d = _params_np(seed, B)
    X, U, sig = jax.vmap(lambda p: jrk.initial_guess(p, K))(_jparams(d))
    rng = np.random.default_rng(seed + 100)
    X = np.asarray(X) + 0.05 * rng.standard_normal((B, K, jrk.NX))
    q = X[..., 7:11]
    X[..., 7:11] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    U = np.asarray(U) + 0.1 * rng.standard_normal((B, K, jrk.NU))
    sig = np.asarray(sig) * (1.0 + 0.1 * rng.standard_normal(B))
    return d, X, U, sig


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ modules
def test_dynamics_and_jacobians():
    d = _params_np(0, 8)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, jrk.NX))
    x[:, 0] = 1.5 + 0.2 * rng.random(8)
    x[:, 7:11] /= np.linalg.norm(x[:, 7:11], axis=-1, keepdims=True)
    u = rng.standard_normal((8, jrk.NU))
    mj = jrk.rocket6dof_model()
    mt = trk.rocket6dof_model()
    fj = jax.vmap(mj.f)(_jparams(d), jnp.asarray(x), jnp.asarray(u))
    Aj, Bj = jax.vmap(mj.jacobians)(_jparams(d), jnp.asarray(x), jnp.asarray(u))
    ft, At, Bt = mt.f_and_jacobians(_tparams(d), _t(x), _t(u))
    _close(ft, fj, 1e-12, 1e-12, "f")
    _close(At, Aj, 1e-12, 1e-12, "A")
    _close(Bt, Bj, 1e-12, 1e-12, "B")
    _close(trk.state_basis(None, _t(x)),
           jax.vmap(lambda xx: jrk.state_basis(None, xx))(jnp.asarray(x)),
           1e-12, 1e-12, "state_basis")
    _close(trk.project_jac(_t(x)), jax.vmap(jrk.project_jac)(jnp.asarray(x)),
           1e-12, 1e-12, "project_jac")


@pytest.fixture(scope="module")
def problems():
    """Discretization, StageSOCP and its Ruiz equilibration on both sides."""
    d, X, U, sig = _trajectories(2)
    tr = np.array([1.0, 0.3, 0.05])
    pscale = np.array([1.0, 10.0, 1.0])
    mj = jrk.rocket6dof_model()
    mt = trk.rocket6dof_model()
    cfg = JScvxConfig()

    def jone(p, x, u, s, r, ps):
        disc = jdiscretize(mj, p, x, u, s, substeps=SUBSTEPS)
        dd = jsocp.assemble(mj, cfg, p, disc, x, u, s, r, free_final_time=True,
                            penalty_scale=ps)
        return disc, dd, jeq.equilibrate(dd, iters=3)

    disc_j, d_j, eq_j = jax.jit(jax.vmap(jone))(
        _jparams(d), jnp.asarray(X), jnp.asarray(U), jnp.asarray(sig),
        jnp.asarray(tr), jnp.asarray(pscale))
    pt = _tparams(d)
    disc_t = tdiscretize(mt, pt, _t(X), _t(U), _t(sig), substeps=SUBSTEPS)
    d_t = tsocp.assemble(mt, ScvxConfig(), pt, disc_t, _t(X), _t(U), _t(sig),
                         _t(tr), free_final_time=True, penalty_scale=_t(pscale))
    eq_t = teq.equilibrate(d_t, iters=3)
    return (disc_j, d_j, eq_j), (disc_t, d_t, eq_t)


def _compare_trees(tj, tt, rtol, name):
    lj = jax.tree.leaves(_tree_np(tj))
    lt = jax.tree.leaves(tt, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert len(lj) == len(lt), name
    for i, (a, b) in enumerate(zip(lt, lj)):
        scale = max(1.0, float(np.max(np.abs(b)))) if b.size else 1.0
        _close(a, b, rtol, rtol * scale, f"{name}[{i}]")


def test_discretization_fields(problems):
    (disc_j, _, _), (disc_t, _, _) = problems
    for f in disc_t._fields:
        ref = np.asarray(getattr(disc_j, f))
        _close(getattr(disc_t, f), ref, 1e-10, 1e-10 * np.abs(ref).max(), f)


def test_stage_socp_fields(problems):
    (_, d_j, _), (_, d_t, _) = problems
    _compare_trees(d_j, d_t, 1e-10, "StageSOCP")


def test_equilibrated_problem_and_scales(problems):
    (_, _, eq_j), (_, _, eq_t) = problems
    _compare_trees(eq_j[0], eq_t[0], 1e-10, "equilibrated")
    _compare_trees(eq_j[1], eq_t[1], 1e-10, "scales")


# --------------------------------------------------- kernels' plain versions
def _interior_np(h, rng):
    """Random strictly interior cone points shaped like cone_h (numpy)."""
    out = {}
    for k, v in h.items():
        v = np.asarray(v)
        if k in ("lin", "pq", "sig"):
            out[k] = np.maximum(1.0 + 0.3 * rng.random(v.shape), 0.3)
        else:
            e = np.zeros(v.shape)
            e[..., 0] = 1.0
            p = e * (1.0 + 0.3 * rng.random(v.shape))
            p[..., 1:] = 0.3 * rng.standard_normal(v.shape[:-1] + (v.shape[-1] - 1,))
            need = np.linalg.norm(p[..., 1:], axis=-1) + 0.3
            p[..., 0] = np.maximum(p[..., 0], need)
            out[k] = p
    return out


def test_fused_factor_plain_matches_jax_factorize(problems):
    """cuda_fused.fused_factor (plain on the CPU) via the port's factorize
    against the JAX package's unfused factorize, on assembled rocket
    subproblems with a genuine (non-identity) NT scaling."""
    (_, d_j, _), (_, d_t, _) = problems
    rng = np.random.default_rng(5)
    h_np = _tree_np(jax.vmap(jsocp.cone_h)(d_j))
    s_np, z_np = _interior_np(h_np, rng), _interior_np(h_np, rng)
    spec = jipm._spec_of(jax.tree.map(lambda a: a[0], d_j))
    W_j = jax.vmap(lambda s, z: jC.nt_scaling(spec, s, z))(
        jax.tree.map(jnp.asarray, s_np), jax.tree.map(jnp.asarray, z_np))
    W_t = tC.nt_scaling(spec, {k: _t(v) for k, v in s_np.items()},
                        {k: _t(v) for k, v in z_np.items()})
    _compare_trees(W_j, W_t, 1e-12, "W")
    f_j = jax.jit(jax.vmap(
        lambda dd, ww: jipm.factorize(dd, ww, JIPMConfig(use_pallas=False))))(
            d_j, W_j)
    f_t = tipm.factorize(d_t, W_t, IPMConfig())
    _close(f_t.chol_Hw, f_j.chol_Hw, 1e-9, 1e-11, "chol_Hw")
    _close(f_t.tri[0], f_j.tri[0], 1e-9, 1e-11, "L")
    _close(f_t.tri[1], f_j.tri[1], 1e-9, 1e-11, "C")
    _close(f_t.sm_t, f_j.sm_t, 1e-9, 1e-11, "sm_t")


def _spd_blocks(rng, shape, n):
    A = rng.standard_normal(shape + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def test_tridiag_solve_plain_matches_jax():
    rng = np.random.default_rng(8)
    N, n = 7, 5
    D = _spd_blocks(rng, (B, N), n)
    O = 0.3 * rng.standard_normal((B, N - 1, n, n))
    r = rng.standard_normal((B, N, n))
    Lj, Cj = jax.vmap(jla.blocktridiag_factor)(jnp.asarray(D), jnp.asarray(O))
    uj = jax.vmap(jla.blocktridiag_solve)(Lj, Cj, jnp.asarray(r))
    Lt, Ct = tla.blocktridiag_factor(_t(D), _t(O))
    _close(Lt, Lj, 1e-10, 1e-12, "L")
    _close(Ct, Cj, 1e-10, 1e-12, "C")
    ut = cuda_kkt.tridiag_solve(_t(Lj), _t(Cj), _t(r))
    _close(ut, uj, 1e-10, 1e-12, "u")


# the main path's widths, which the two redesigned kernels are tuned for:
# K=50 nodes, R=38 H rows of nw=17, nrx=13 Schur rows, the rocket's cone
# layout (3 linear rows, then cones of 3, 3, 4, 4, 4 and the 17-row trust
# region)
ROCKET_SOC_RANGES = ((3, 6), (6, 9), (9, 13), (13, 17), (17, 21), (21, 38))


def test_fused_factor_plain_matches_jax_reference_at_main_widths():
    """``fused_factor_plain`` (what csrc/fused_factor.cu is held to on the
    card) against the JAX package's ``pallas_fused._reference_factor`` under
    vmap, B=2, K=50, R=38, nw=17, nrx=13, f64 round-off (rtol 1e-10).
    Positive row weights, cone coefficients and diagonals keep every H_k
    and Schur block SPD."""
    rng = np.random.default_rng(11)
    Bm, Km, nw, nrx = 2, 50, 17, 13
    R, S = ROCKET_SOC_RANGES[-1][1], len(ROCKET_SOC_RANGES)
    args = (rng.standard_normal((Bm, Km, R, nw)),
            0.5 + rng.random((Bm, Km, R)),
            rng.standard_normal((Bm, Km, R)),
            0.1 + rng.random((Bm, Km, S)),
            0.1 + rng.random((Bm, Km, nw)),
            rng.standard_normal((Bm, Km - 1, nrx, nw)),
            rng.standard_normal((Bm, Km - 1, nrx, nw)),
            0.1 + rng.random((Bm, Km - 1, nrx)))
    ref = jax.vmap(lambda *a: pallas_fused._reference_factor(
        *a, ROCKET_SOC_RANGES))(*map(jnp.asarray, args))
    out = cuda_fused.fused_factor_plain(
        *map(_t, args), torch.tensor(ROCKET_SOC_RANGES, dtype=torch.int32))
    for name, t, j in zip(("chol_Hw", "L", "C"), out, ref):
        _close(t, j, 1e-10, 1e-10 * float(np.abs(np.asarray(j)).max()), name)


def test_tridiag_solve_plain_matches_jax_at_main_widths():
    """``tridiag_solve_plain`` (what the tridiag_solve kernel is held to)
    against JAX's ``smallla.blocktridiag_solve`` at N=49, n=13, B=2, f64
    round-off (rtol 1e-10)."""
    rng = np.random.default_rng(12)
    N, n = 49, 13
    D = _spd_blocks(rng, (2, N), n)
    O = 0.3 * rng.standard_normal((2, N - 1, n, n))
    r = rng.standard_normal((2, N, n))
    Lj, Cj = jax.vmap(jla.blocktridiag_factor)(jnp.asarray(D), jnp.asarray(O))
    uj = jax.vmap(jla.blocktridiag_solve)(Lj, Cj, jnp.asarray(r))
    ut = cuda_kkt.tridiag_solve_plain(_t(Lj), _t(Cj), _t(r))
    _close(ut, uj, 1e-10, 1e-10 * float(np.abs(np.asarray(uj)).max()), "u")


@pytest.mark.parametrize("n", [17, 11])
def test_cho_solve_vec_plain_matches_jax(n):
    """At the stage widths the cho_solve_vec kernel compiles in: the
    rocket's nw = 17 and the point mass's 11."""
    rng = np.random.default_rng(9)
    H = _spd_blocks(rng, (B * K,), n)
    b = rng.standard_normal((B * K, n))
    L = np.linalg.cholesky(H)
    xj = jla.cho_solve(jnp.asarray(L), jnp.asarray(b))
    xt = cuda_kkt.cho_solve_vec(_t(L), _t(b))
    _close(xt, xj, 1e-10, 1e-12, "x")


def _zero_dividend_grid(dtype):
    """Every pair (s, d) with s and d in {+-0, +-1, +-the smallest
    subnormal, +-max, +-inf, NaN}, d also over seeded random finite values
    of every magnitude."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    fi = np.finfo(np_dt)
    sub = np.nextafter(np_dt(0), np_dt(1))
    special = np.array([0.0, -0.0, 1.0, -1.0, sub, -sub, fi.max, -fi.max,
                        np.inf, -np.inf, np.nan], dtype=np_dt)
    rng = np.random.default_rng(16)
    exps = rng.uniform(np.log10(float(fi.tiny)), np.log10(float(fi.max)), 200)
    rand = (rng.choice([-1.0, 1.0], 200) * 10.0 ** exps).astype(np_dt)
    s = torch.from_numpy(special)
    d = torch.from_numpy(np.concatenate([special, rand]))
    return torch.meshgrid(s, d, indexing="ij")


def _same_bits(a, b):
    """Equal bit for bit, NaN equal to NaN (whatever its payload)."""
    ib = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a.view(ib) == b.view(ib)) | (torch.isnan(a) & torch.isnan(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zero_dividend_quotient_is_the_division_bit_for_bit(dtype):
    """The identity that csrc/divide.cuh's div_zs (the cho_solve and
    discretize kernels' division) relies on: s * copysign(1, d) where s is
    +-0 and |d| > 0, else s / d, is s / d bit for bit for every s and d
    (signed zeros, subnormals, infinities, NaN), so a zero dividend can skip
    the division's slow path and keep the first design's results."""
    S, D = _zero_dividend_grid(dtype)
    q = torch.where((S == 0) & (D.abs() > 0),
                    S * torch.copysign(torch.ones_like(D), D), S / D)
    assert bool(_same_bits(q, S / D).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reciprocal_zero_dividend_form_is_not_the_division(dtype):
    """The form s == 0 ? s * (1 / d) : s / d is NOT the division: at the
    smallest subnormal d, 1 / d overflows to infinity and 0 * inf is NaN
    where 0 / d is a signed zero. Recorded so that nobody brings it back."""
    S, D = _zero_dividend_grid(dtype)
    q = torch.where(S == 0, S * (1 / D), S / D)
    bad = ~_same_bits(q, S / D)
    assert bool(bad.any())
    assert bool((S[bad] == 0).all()) and bool(torch.isinf(1 / D[bad]).all())
    assert bool(torch.isnan(q[bad]).all())
    assert bool((D[bad].abs() == D[bad].abs().min()).all())


def _ipm_cho_solve_inputs(rng, Bl, Kn, nw, nrx):
    """chol_Hw (Bl, Kn, nw, nw) lower factors and E (Bl, Kn-1, nrx, nw)
    with exact-zero rows and entries, as the unfused factorize holds them."""
    L = np.linalg.cholesky(_spd_blocks(rng, (Bl, Kn), nw))
    E = rng.standard_normal((Bl, Kn - 1, nrx, nw))
    E[:, :, 3:5] = 0.0
    E[rng.random(E.shape) < 0.25] = 0.0
    return L, E


def test_cho_solve_plain_matches_jax_in_the_ipm_layout():
    """``cuda_kkt.cho_solve`` on CPU tensors (its plain version, which the
    kernel is held to on the card) given what ``ops/ipm.py`` passes:
    ``chol_Hw[:, :-1]`` of a (B, K, 17, 17) factor and ``E.transpose(-1,
    -2)`` of a (B, K-1, 13, 17) E with exact-zero rows, against JAX's
    ``smallla.cho_solve`` on the same numpy inputs, f64 round-off (rtol
    1e-10). The kernel reads both views in place: ``cho_solve_layout``
    takes them as K-1 blocks a lane, lanes K*17*17 apart, B transposed."""
    rng = np.random.default_rng(17)
    Bl, Kn, nw, nrx = 2, K, 17, 13
    L, E = _ipm_cho_solve_inputs(rng, Bl, Kn, nw, nrx)
    Lt, Et = _t(L), _t(E)
    Lv, Bv = Lt[:, :-1], Et.transpose(-1, -2)
    assert not Lv.is_contiguous() and not Bv.is_contiguous()
    assert cuda_kkt.cho_solve_layout(Lv, Bv) == (Kn - 1, Kn * nw * nw, 1)
    Xt = cuda_kkt.cho_solve(Lv, Bv)
    Xj = jla.cho_solve(jnp.asarray(L[:, :-1]),
                       jnp.asarray(np.swapaxes(E, -1, -2)))
    _close(Xt, Xj, 1e-10, 1e-10 * float(np.abs(np.asarray(Xj)).max()), "X")
    assert cuda_kkt.cho_solve.launches == 0


def test_cho_solve_layout_refuses_what_the_kernel_does_not_read():
    """The layouts the cho_solve kernel reads in place (the IPM's slices
    of one factor, B row-major or transposed, contiguous tensors) and the
    ones its wrapper refuses on the card instead of copying: B's columns
    strided, L's blocks column-major, lanes of B not evenly spaced, L's
    blocks repeated by a zero stride. A pure function of shapes and
    strides, so the CPU decides it as the card does."""
    rng = np.random.default_rng(18)
    L, E = _ipm_cho_solve_inputs(rng, 3, 5, 17, 13)
    Lt, Et = _t(L), _t(E)
    Bt = Et.transpose(-1, -2)
    lay = cuda_kkt.cho_solve_layout
    assert lay(Lt[:, :-1], Bt) == (4, 5 * 289, 1)
    assert lay(Lt[:, 1:], Bt) == (4, 5 * 289, 1)
    assert lay(Lt[:, :-1], Bt.contiguous()) == (4, 5 * 289, 0)
    assert lay(Lt[:, :-1].contiguous(), Bt) == (12, 12 * 289, 1)
    assert lay(Lt[:1, :-1], Bt[:1]) == (4, 4 * 289, 1)
    assert lay(Lt[0, 0], Bt[0, 0]) == (1, 289, 1)
    wide = torch.zeros(3, 4, 17, 26, dtype=F64)
    for what, Lb, Bb in (
            ("B's columns strided", Lt[:, :-1], wide[..., ::2]),
            ("L's blocks column-major", Lt[:, :-1].transpose(-1, -2), Bt),
            ("B's lanes not evenly spaced", Lt[:, :-1],
             torch.zeros(3, 5, 17, 13, dtype=F64)[:, :-1]),
            ("L's blocks repeated by a zero stride",
             Lt[:1, :1].expand(3, 4, 17, 17), Bt)):
        with pytest.raises(ValueError):
            lay(Lb, Bb)


def test_tridiag_factor_plain_matches_jax_at_penalized_widths():
    """``tridiag_factor_plain`` (what the tridiag_factor kernel, with the
    rocket's nrx = 13 compiled in, is held to on the card) against JAX's
    ``smallla.blocktridiag_factor`` under vmap at the penalized path's
    N=49, n=13, B=2, f64 round-off (rtol 1e-10)."""
    rng = np.random.default_rng(14)
    N, n = 49, 13
    D = _spd_blocks(rng, (2, N), n)
    O = 0.3 * rng.standard_normal((2, N - 1, n, n))
    Lj, Cj = jax.vmap(jla.blocktridiag_factor)(jnp.asarray(D), jnp.asarray(O))
    Lt, Ct = cuda_kkt.tridiag_factor_plain(_t(D), _t(O))
    for name, t, j in (("L", Lt, Lj), ("C", Ct, Cj)):
        _close(t, j, 1e-10, 1e-10 * float(np.abs(np.asarray(j)).max()), name)


def _finite_parts_match(t, j, msg):
    t, j = _np(t), _np(j)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j), err_msg=msg)
    fin = np.isfinite(j)
    _close(t[fin], j[fin], 1e-10, 1e-10 * float(np.abs(j[fin]).max()), msg)


def test_plain_factors_factor_on_at_an_infinite_pivot():
    """An infinite diagonal entry is not a breakdown: LAPACK potrf's test,
    which the JAX package's factors and the port's plain versions share and
    the chol, fused_chol_solve and tridiag_factor kernels follow. The
    factor holds that infinite entry with zeros below it and is finite
    elsewhere; the solve gives that unknown 0; the block-tridiagonal factor
    goes on finite in the later blocks of the lane. The plain versions
    against JAX's ``smallla.chol``, ``smallla.cho_solve`` on that factor
    and ``smallla.blocktridiag_factor``: the same non-finite entries, f64
    round-off elsewhere."""
    rng = np.random.default_rng(15)
    n, j = 13, 5
    A = _spd_blocks(rng, (4,), n)
    A[1, j, j] = np.inf
    R = rng.standard_normal((4, n, 2))
    Lj = jla.chol(jnp.asarray(A))
    Lt = cuda_kkt.chol(_t(A))
    _finite_parts_match(Lt, Lj, "chol")
    assert np.isinf(_np(Lt)[1, j, j]) and int(np.isinf(_np(Lt)).sum()) == 1
    assert np.all(_np(Lt)[1, j + 1:, j] == 0.0)
    Xt = cuda_kkt.fused_chol_solve(_t(A), _t(R))
    _finite_parts_match(Xt, jla.cho_solve(Lj, jnp.asarray(R)), "fused_chol_solve")
    assert np.isfinite(_np(Xt)).all() and np.all(_np(Xt)[1, j] == 0.0)
    D = _spd_blocks(rng, (2, 6), n)
    O = 0.3 * rng.standard_normal((2, 5, n, n))
    D[1, 3, j, j] = np.inf
    Lj, Cj = jax.vmap(jla.blocktridiag_factor)(jnp.asarray(D), jnp.asarray(O))
    Lt, Ct = cuda_kkt.tridiag_factor(_t(D), _t(O))
    _finite_parts_match(Lt, Lj, "tridiag_factor L")
    _finite_parts_match(Ct, Cj, "tridiag_factor C")
    assert np.isinf(_np(Lt)[1, 3, j, j]) and int(np.isinf(_np(Lt)).sum()) == 1
    assert np.isfinite(_np(Ct)).all() and np.all(_np(Ct)[1, 4, j] == 0.0)


def _column_order_chol(A, dt):
    """The first chol design's order (one warp a block, in shared memory):
    left-looking, column j at a time, s_i = A[i][j] - sum_{k<j, ascending}
    L[i][k] L[j][k] for i >= j, the pivot s_j, d = sqrt(s_j), L[i][j] =
    s_i / d. Only the lower triangle is read. Returns (L, breakdown)."""
    n = A.shape[0]
    L = [[dt(0)] * n for _ in range(n)]
    bad = False
    for j in range(n):
        s = {}
        for i in range(j, n):
            v = dt(A[i, j])
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            s[i] = v
        bad = bad or not s[j] > 0
        d = np.sqrt(s[j])
        L[j][j] = d
        for i in range(j + 1, n):
            L[i][j] = s[i] / d
    return np.array(L, dtype=dt), bad


def _row_order_chol(A, dt, lower_only):
    """The row-a-lane factor: 32 lanes, lane a row a with the upper
    triangle mirrored (row[b] = A[a][min(a, b)]; lanes >= n shadow row 0),
    right-looking, every lane computing every entry: at column j the pivot
    from lane j, q = row[j] / sqrt(pivot), then row[c] - L[a][j] L[c][j].
    With selects that keep the upper triangle (csrc/blocktri.cuh
    warp_chol_rows, tridiag_factor's and the fused factorization's) or,
    ``lower_only``, with none, and a zero dividend's quotient the signed
    zero s * copysign(1, d) while d / d is divided in its place
    (csrc/kkt.cu warp_chol_lower, the chol kernels')."""
    n = A.shape[0]
    lcs = [a if a < n else 0 for a in range(32)]
    rows = [[dt(A[lc, min(b, lc)]) for b in range(n)] for lc in lcs]
    bad = False
    for j in range(n):
        piv = rows[j][j]
        bad = bad or not piv > 0
        d = np.sqrt(piv)
        for row, lc in zip(rows, lcs):
            z = lower_only and row[j] == 0
            q = (d if z else row[j]) / d
            if lower_only:
                row[j] = d if lc == j else (
                    row[j] * np.copysign(dt(1), d) if z else q)
            else:
                row[j] = d if lc == j else (q if lc > j else row[j])
        lj = [row[j] for row in rows]
        for c in range(j + 1, n):
            for a, (row, lc) in enumerate(zip(rows, lcs)):
                upd = row[c] - lj[a] * lj[c]
                row[c] = upd if lower_only or lc >= c else row[c]
    L = np.array([[rows[a][b] if b <= a else dt(0) for b in range(n)]
                  for a in range(n)], dtype=dt)
    return L, bad


@pytest.mark.parametrize("dt", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_row_cholesky_order_is_the_column_order_bit_for_bit(dt):
    """The invariant the chol and fused_chol_solve kernels rest on: the
    row-a-lane, right-looking factor (the upper triangle mirrored; with
    the selects, warp_chol_rows, and in the chol kernels' lean form
    without them and with zero dividends off the division,
    warp_chol_lower) takes the first
    design's left-looking column order operation for operation, so they
    give the same bits. numpy scalars in the working type (no fused
    multiply-add: both orders contract the same products on the card),
    seeded, at n = 17 (the stage Hessian) and 13, with a quarter of the
    lower triangle exact zeros, an infinite pivot (it factors on) and an
    indefinite block (a breakdown in all)."""
    rng = np.random.default_rng(16)
    ib = np.uint32 if dt == np.float32 else np.uint64
    with np.errstate(all="ignore"):
        for n in (17, 13):
            for case in ("spd", "inf", "indefinite"):
                R = np.tril(rng.standard_normal((n, n)), -1)
                R[rng.random((n, n)) < 0.25] = 0.0
                A = R + R.T
                A += (1.0 - np.linalg.eigvalsh(A)[0]) * np.eye(n)
                if case == "inf":
                    A[5, 5] = np.inf
                if case == "indefinite":
                    A -= (np.linalg.eigvalsh(A)[0] + 1.0) * np.eye(n)
                A = A.astype(dt)
                Lc, bad_c = _column_order_chol(A, dt)
                assert bad_c == (case == "indefinite")
                for lower_only in (False, True):
                    Lr, bad_r = _row_order_chol(A, dt, lower_only)
                    assert bad_r == bad_c
                    if bad_c:
                        continue
                    assert np.array_equal(Lc.view(ib), Lr.view(ib)), (
                        n, case, lower_only)
                assert np.isinf(Lc[5, 5]) == (case == "inf")
                if not bad_c:
                    assert np.isfinite(
                        np.delete(np.delete(Lc, 5, 0), 5, 1)).all()


def test_fused_chol_solve_plain_matches_pallas():
    """``cuda_kkt.fused_chol_solve`` on CPU tensors (its plain version: chol
    then cho_solve, which the CUDA kernel is held to on the card) against
    the TPU kernel ``pallas_kkt.fused_chol_solve`` run in interpret mode,
    at the JAX test vehicle's n=13, m=2 (N=40 blocks, where the vehicle has
    300, to keep the interpreted kernel short); f64 round-off, rtol 1e-10.
    A block that is not positive definite comes out entirely NaN."""
    rng = np.random.default_rng(10)
    A = _spd_blocks(rng, (40,), 13)
    R = rng.standard_normal((40, 13, 2))
    Xj = pallas_kkt.fused_chol_solve(jnp.asarray(A), jnp.asarray(R),
                                     interpret=True)
    X = cuda_kkt.fused_chol_solve(_t(A), _t(R))
    assert cuda_kkt.fused_chol_solve.launches == 0
    _close(X, Xj, 1e-10, 1e-12, "X")
    A[5] -= (np.linalg.eigvalsh(A[5])[0] + 1.0) * np.eye(13)
    Xb = cuda_kkt.fused_chol_solve(_t(A), _t(R)).numpy()
    assert np.isnan(Xb[5]).all()
    np.testing.assert_array_equal(np.delete(Xb, 5, 0),
                                  np.delete(X.numpy(), 5, 0))


def test_wrappers_launch_or_raise():
    """Off the CPU a wrapper launches its kernel or raises; it never falls
    back to the plain version (a 'meta' tensor is neither CPU nor CUDA)."""
    L = torch.eye(3, dtype=F64).expand(2, 3, 3).to("meta")
    b = torch.zeros(2, 3, dtype=F64).to("meta")
    with pytest.raises(ValueError):
        cuda_kkt.cho_solve_vec(L, b)
    with pytest.raises(ValueError):
        cuda_kkt.tridiag_solve(L[None], L[None], b[None])
    with pytest.raises(ValueError):
        cuda_kkt.tridiag_factor(L[None], L[None, :1])
    with pytest.raises(ValueError):
        cuda_kkt.fused_chol_solve(L, L)
    G = torch.zeros(1, 3, 4, 5, dtype=F64, device="meta")
    with pytest.raises(ValueError):
        cuda_fused.fused_factor(G, G[..., 0], G[..., 0], G[..., :1, 0],
                                G[:, :, 0], G[:, :2], G[:, :2], G[:, :2, :, 0],
                                torch.zeros(1, 2, dtype=torch.int32))
