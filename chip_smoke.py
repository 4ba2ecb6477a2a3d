#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``successiveconvexification_tpu_torch``
from beside this file and never imports JAX or the JAX package). Phases:

  1. the card's name and power limit (nvidia-smi) and the kernels' build;
  2. the main path: a B=256 Monte-Carlo sweep of the 6-DoF rocket at K=50,
     8 RK4 substeps, float32, with the settings of ``bench.py`` (IPM cap 15,
     one refinement step, warm start, scan KKT, Ruiz on cold solves, SCvx
     cap 120, compaction with min bucket 32 and chunk 10), dispersions from
     a torch.Generator seeded with 0. Every kernel launch counter is set to
     0 just before and read just after; every kernel must have launched,
     and the counts must match the IPM's structure;
  2b. the replan path (``bench.py``'s BENCH_MODE=replan, the same settings
     with the PCR KKT backend): a cold single-lane solve of the nominal
     scenario, r_init moved by (0.2, -0.2, 0.1), ``scvx_warm_start`` with
     the STM correction, then general-branch SCvx iterations with a device
     sync after each until the lane re-converges, at most bench.py's 40.
     Counters as in phase 2: chol, cho_solve and cho_solve_vec must match
     the IPM's structure, and the fused route's kernels must not launch;
     the cold solve must converge. Then one warm replan iteration under
     torch.profiler (device busy share, device operations, aten calls), and
     the same path at static_reg 1e-6 (``REPLAN_CHECK_REG`` says why) with
     bench.py's cap of 40: both of its solves must converge;
  3. each kernel against its plain PyTorch version on inputs captured from
     those runs (main path: its first call inside the first IPM iteration,
     and every call of the 10th lockstep SCvx iteration, whose warm IPM ends
     near optimality where conditioning is worst; replan path: the first IPM
     iteration of the cold solve and every call of the last replan
     iteration), in float32 and float64: the kernel must be finite wherever
     success in its dtype is guaranteed, and there its residuals within
     their backward-error bounds and its error against the float64 plain
     version within the forward error those bounds permit (``check_call``);
     the wrappers must refuse what the kernels do not take;
  4. f64 on the card beside the same runs on the CPU with the plain
     versions (child processes, Ruiz on every solve): B=4 of the main path
     at K=50, and the replan path at K=50 with the static KKT
     regularization at 1e-6 (``REPLAN_CHECK_REG`` says why); sigma within
     1e-6 relative, identical iteration counts and converged flags;
  5. each kernel's time at its path's shapes beside its bound, its plain
     version's time and, where one exists, one PyTorch library call's time
     (chol and cho_solve also at a B=256 batch of blocks, for the record).

The line before the last is the kernels' JSON record; the last line is the
run's verdict ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line. ``--cpu-reference PATH`` and ``--cpu-replan
PATH`` are the child modes of phase 4 (CPU only).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

MAIN_B, MAIN_K, MAIN_SUBSTEPS = 256, 50, 8
REF_B = 4
REPLAN_DR = (0.2, -0.2, 0.1)    # bench.py's replan move of r_init
BENCH_REPLAN_ITERS = 40         # bench.py's replan loop
# Static KKT regularization of the replan runs that must converge. At the
# default 1e-8 the PCR solve's residual plateaus late in the IPM (PCR's
# combined solution does not solve one nearby system), so most subproblems
# end uncertified and the summation order decides the path. In f32 on the
# H100 the replan re-converged within 40 iterations for 3 of 4 moves of
# r_init with the kernels, 3 of 4 with chol and cho_solve swapped for their
# plain versions, 2 of 4 with every kernel of the path swapped, and 3 of 4
# on the CPU; every column stuck on some move, not on the same ones, and
# bench.py's move sticks with the kernels (defect+violation 1.92e-4, above
# the f32 feasibility floor of 1.67e-4). At 1e-6 both solves
# converge, and in f64 PCR gives the scan route's trajectory (ROADMAP
# Queue 3; scripts/replan_diagnostic.py takes these readings).
REPLAN_CHECK_REG = 1e-6

KERNELS = {
    "fused_factor": dict(
        source="successiveconvexification_tpu_torch/csrc/fused_factor.cu",
        replaces="successiveconvexification_tpu/ops/pallas_fused.py:245"),
    "tridiag_solve": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:451"),
    "cho_solve_vec": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:201"),
    "chol": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:160"),
    "cho_solve": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:201"),
}
# launches per IPM iteration and per cold init (ipm.py structure). An IPM
# iteration factors once and runs three KKT solves (predictor, corrector,
# one refinement), each with two stage-Hessian solves; a cold init factors
# once and runs two KKT solves. The fused route adds a tridiag_solve per
# KKT solve and one for the Sherman-Morrison vector; the PCR route factors
# H with chol and forms H^-1 E', H^-1 F' with two cho_solve launches.
PER_ITER = {"fused_factor": 1, "tridiag_solve": 4, "cho_solve_vec": 6,
            "chol": 0, "cho_solve": 0}
PER_COLD = {"fused_factor": 1, "tridiag_solve": 3, "cho_solve_vec": 4,
            "chol": 0, "cho_solve": 0}
REPLAN_PER_ITER = {"fused_factor": 0, "tridiag_solve": 0, "cho_solve_vec": 6,
                   "chol": 1, "cho_solve": 2}
REPLAN_PER_COLD = {"fused_factor": 0, "tridiag_solve": 0, "cho_solve_vec": 4,
                   "chol": 1, "cho_solve": 2}
LATE_LOCKSTEP = 10


class PhaseError(RuntimeError):
    pass


def _import_port():
    sys.path.insert(0, ROOT)
    import successiveconvexification_tpu_torch as P  # noqa: F401
    from successiveconvexification_tpu_torch.ops import _build, cuda_fused, cuda_kkt

    return P, _build, cuda_fused, cuda_kkt


def _configs(P, dtype: str, K: int, substeps: int, bench: bool,
             kkt: str = "scan", static_reg: float = 1e-8):
    if bench:
        ipm = P.IPMConfig(max_iters=15, refine_steps=1, warm_start=True,
                          use_pallas=True, kkt_solver=kkt,
                          static_reg=static_reg)
    else:
        # the f64 card-vs-CPU check: Ruiz on every solve and the default IPM
        # cap keep each subproblem solved to tolerance, so the two runs stay
        # on one path (capped, unequilibrated warm solves make the f64 IPM
        # path sensitive to summation order)
        ipm = P.IPMConfig(equilibrate_cold_only=False, kkt_solver=kkt,
                          static_reg=static_reg)
    return P.SolverConfig(
        dtype=dtype, disc=P.DiscretizationConfig(K=K, substeps=substeps),
        ipm=ipm, scvx=dataclasses.replace(P.ScvxConfig(), max_iters=120))


def _dispersed(P, B: int, dtype, device):
    import torch
    from successiveconvexification_tpu_torch.models import rocket6dof as rk

    params = rk.default_params(dtype=dtype, device=device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    return P.sample_dispersions(params, gen, B, r_std=0.2, v_std=0.1,
                                m_frac_std=0.03)


def replan(P, model, cfg, device: str, cap: int, before=None, after=None,
           dr=REPLAN_DR, cold=None):
    """The replan path: a cold single-lane solve of the nominal scenario
    (or the given ``cold`` solution), r_init moved by ``dr``,
    ``scvx_warm_start`` with the STM correction, then general-branch SCvx
    iterations until the lane converges (at most ``cap``), with a device
    sync after each (bench.py's replan mode). ``before``/``after`` are
    called around each replan iteration. ``marks`` has one letter per
    replan iteration: C where its IPM certified convergence, s where not."""
    import torch
    from successiveconvexification_tpu_torch.models import rocket6dof as rk

    dtype = getattr(torch, cfg.dtype)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    params = rk.default_params(dtype=dtype, device=device)
    sync()
    t0 = time.perf_counter()
    if cold is None:
        cold = P.scvx_solve(model, params, cfg, device=device)
    sync()
    cold_s = time.perf_counter() - t0
    p2 = params.replace(r_init=params.r_init + torch.tensor(
        dr, dtype=dtype, device=device)).map(lambda v, tail: v[None])
    t0 = time.perf_counter()
    warm0 = P.scvx_warm_start(model, p2, cfg, cold.X[0], cold.U[0],
                              cold.sigma[0])
    sync()
    warm_start_ms = 1e3 * (time.perf_counter() - t0)
    warm, lat_ms, marks = warm0, [], ""
    for _ in range(cap):
        if before:
            before()
        t0 = time.perf_counter()
        warm = P.scvx_iteration(model, p2, cfg, warm)
        sync()
        lat_ms.append(1e3 * (time.perf_counter() - t0))
        if after:
            after()
        marks += "C" if bool(warm.ipm_carry.converged.all()) else "s"
        if bool(warm.converged.all()):
            break
    return dict(cold=cold, warm=warm, warm0=warm0, params=p2, cold_s=cold_s,
                warm_start_ms=warm_start_ms, lat_ms=lat_ms, marks=marks)


def run_replan(P, batch_mod, model, cfg, wrappers, caps, cap: int, card: str):
    """Drive the replan path on the card with every launch counter set to 0
    just before and read just after; print its line and its launches, and
    fail unless the trajectories are finite and the counts match the IPM's
    structure (chol, cho_solve and cho_solve_vec launched, the fused route's
    kernels not). ``caps`` keep the inputs of the first IPM iteration of the
    cold solve and of every call of the last replan iteration."""
    import torch

    n_solve_cold = {"n": 0}
    orig_iter = batch_mod.scvx_iteration

    def counting_iteration(model_, params_, cfg_, st_, assume_warm_valid=False):
        n_solve_cold["n"] += 0 if assume_warm_valid else 1
        return orig_iter(model_, params_, cfg_, st_,
                         assume_warm_valid=assume_warm_valid)

    def before():
        for c in caps.values():
            c.recent.clear()

    def after():
        for c in caps.values():
            c.late = list(c.recent)

    batch_mod.scvx_iteration = counting_iteration
    try:
        for w in wrappers.values():
            w.launches = 0
        r = replan(P, model, cfg, "cuda", cap, before, after)
        launches = {k: w.launches for k, w in wrappers.items()}
    finally:
        batch_mod.scvx_iteration = orig_iter
    sm = r["summary"] = _replan_summary(r)
    lat = sorted(r["lat_ms"])
    print(f"replan path: K={MAIN_K} {cfg.dtype} PCR, static_reg "
          f"{cfg.ipm.static_reg:g}: cold solve {r['cold_s']:.3f} s, "
          f"{sm['cold_iterations']} iterations, converged "
          f"{sm['cold_converged']}; warm start {r['warm_start_ms']:.1f} ms; "
          f"replan {sum(lat):.1f} ms, {len(lat)} iterations (cap {cap}), ms "
          f"per SCvx iteration p50 {lat[len(lat) // 2]:.1f} max {lat[-1]:.1f}, "
          f"re-converged {sm['converged']}, final defect+violation "
          f"{sm['defect'] + sm['viol']:.3e}, sigma {sm['cold_sigma']:.5f} -> "
          f"{sm['sigma']:.5f}; {card}")
    # every replan iteration is a general-branch one: it pays a cold init
    n_cold = n_solve_cold["n"] + len(lat)
    n_body = launches["chol"] - n_cold
    expect = {k: REPLAN_PER_ITER[k] * n_body + REPLAN_PER_COLD[k] * n_cold
              for k in launches}
    print(f"  launches: {json.dumps(launches)}; expected from {n_body} IPM "
          f"iterations + {n_cold} cold inits: {json.dumps(expect)}")
    if not all(bool(torch.isfinite(t).all()) for st in (r["cold"], r["warm"])
               for t in (st.X, st.U, st.sigma)):
        raise PhaseError("replan path: non-finite trajectories")
    if any(launches[k] == 0 for k in ("chol", "cho_solve", "cho_solve_vec")):
        raise PhaseError(f"replan path: a kernel never launched: {launches}")
    if launches != expect:
        raise PhaseError("replan path: launch counts do not match the IPM "
                         "(the fused route must not launch)")
    return r, launches


def _replan_summary(r) -> dict:
    cold, warm = r["cold"], r["warm"]
    return {"cold_iterations": int(cold.iterations[0]),
            "cold_converged": bool(cold.converged[0]),
            "cold_sigma": float(cold.sigma[0]),
            "iterations": int(warm.iterations[0]),
            "converged": bool(warm.converged[0]),
            "sigma": float(warm.sigma[0]),
            "defect": float(warm.defect_nl[0]),
            "viol": float(warm.viol_nl[0])}


def cpu_replan(path: str) -> None:
    """Child mode: the f64 K=50 replan path on the CPU with the plain versions."""
    import torch

    torch.set_num_threads(2)
    P, _, _, _ = _import_port()
    cfg = _configs(P, "float64", MAIN_K, MAIN_SUBSTEPS, bench=False, kkt="pcr",
                   static_reg=REPLAN_CHECK_REG)
    t0 = time.perf_counter()
    r = replan(P, P.rocket6dof_model(), cfg, "cpu", cfg.scvx.max_iters)
    out = {**_replan_summary(r), "seconds": time.perf_counter() - t0}
    with open(path, "w") as f:
        json.dump(out, f)


def cpu_reference(path: str) -> None:
    """Child mode: the f64 B=4 K=50 run on the CPU with the plain versions."""
    import torch

    torch.set_num_threads(4)
    P, _, _, _ = _import_port()
    cfg = _configs(P, "float64", MAIN_K, MAIN_SUBSTEPS, bench=False)
    pb = _dispersed(P, REF_B, torch.float64, "cpu")
    t0 = time.perf_counter()
    st = P.solve_batch(P.rocket6dof_model(), pb, cfg, device="cpu")
    out = {"sigma": st.sigma.tolist(), "iterations": st.iterations.tolist(),
           "converged": st.converged.tolist(),
           "seconds": time.perf_counter() - t0}
    with open(path, "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------- helpers
class Capture:
    """Wrap a kernel wrapper to keep (by reference) the inputs of one chosen
    call and of the recent calls; ``late`` is set from those by the caller.
    The wrapped function is the original, so its launch counter is
    untouched by the wrapping."""

    def __init__(self, module, name: str, first_index: int):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.first_index = first_index
        self.calls = 0
        self.first = None
        # more than one SCvx iteration's calls (a cold init and 15 IPM
        # iterations launch at most 16, 63 and 94 of the three kernels)
        self.recent = collections.deque(maxlen=256)
        self.late = None

    # the wrapper increments its counter through its module-level name,
    # which is this object while the capture is installed
    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, value):
        self.orig.launches = value

    def __call__(self, *args):
        if self.calls == self.first_index:
            self.first = args
        self.recent.append(args)
        self.calls += 1
        return self.orig(*args)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _lanes(t):
    """(B, rest) float64 view; axis 0 is the scenario lane."""
    return t.double().reshape(t.shape[0], -1)


def _lane_finite(outs):
    """(B,) bool: every output of the call is finite in the lane."""
    import torch

    return torch.stack([torch.isfinite(_lanes(o)).all(1) for o in outs]).all(0)


# Backward-error gate. A backward-stable factorization or solve reproduces
# its inputs to within a few roundoffs per term, whatever the conditioning
# (Higham, Accuracy and Stability of Numerical Algorithms, ch. 3, 8, 10):
# the componentwise residual |res| / (sum of the absolute values of the
# terms) is at most gamma_N = N u / (1 - N u), u = eps / 2, N the longest
# chain of terms. Each gate below is 2 gamma_N: the kernel's own rounding
# plus that of evaluating the residual in float64. The residuals are
# computed from the kernel's outputs and inputs only; no reference
# implementation enters.
#
# Forward-error gate against the float64 plain version. Its tolerance is
# the forward error that those backward-error bounds permit, computed per
# entry on the float64 reference, with no fitted factor:
#   - a solve with residual r has x - x* = A^-1 r exactly, so
#     |x - x_ref| <= |A^-1| (gamma_k den(x) + gamma_64 den(x_ref)) (Skeel);
#   - a Cholesky factor of A + dA moves, to first order, by
#     L Phi(L^-1 dA L^-T) (Phi: lower triangle, half the diagonal), so
#     |dL| <= |L| Phi(|L^-1| |dA| |L^-T|); the bound is doubled to cover
#     the higher-order terms, which is enough where ||A^-1|| ||dA|| <= 1/2,
#     and the factors are held only in lanes certified so (below).
#
# Finiteness gate. Near the end of an IPM, float32 Cholesky factorizations
# break down (a pivot <= 0, NaN) in many lanes, and which lanes break down
# depends on the order of rounding: two correct implementations disagree
# there. So a kernel must be finite in every lane where success in its
# dtype is GUARANTEED: where the matrix it factors stays positive definite,
# with room for the forward bound, under every perturbation within its
# backward-error bound: lambda_min(A) > 2 ||dA||_2 (Weyl), with ||dA||_2 at
# most gamma_N x the largest row sum of the absolute-term scales; checked
# by a float64 Cholesky of A - 2 gamma_N x (that row sum) x I.
def _gamma(n: int, dtype) -> float:
    import torch

    u = torch.finfo(dtype).eps / 2
    return n * u / (1 - n * u)


def _both(n: int, dtype) -> float:
    """The rounding of the kernel in its dtype plus that of the float64
    reference."""
    import torch

    return _gamma(n, dtype) + _gamma(n, torch.float64)


def _omega(res, den):
    """(B,) max over each lane of |res| / den (a nonzero over 0 is huge)."""
    return _lanes((res.abs() / den.clamp(min=1e-300))).amax(1)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _T(A):
    return A.transpose(-1, -2)


def _eye(n, like):
    import torch

    return torch.eye(n, dtype=like.dtype, device=like.device)


def _chol_forward(Lr, dA):
    """Bound on |L - Lr| for the Cholesky factor of A + dA, |dA| <= dA."""
    import torch

    Li = torch.linalg.solve_triangular(Lr, _eye(Lr.shape[-1], Lr), upper=False)
    X = Li.abs() @ dA @ _T(Li.abs())
    phi = torch.tril(X, -1) + 0.5 * torch.diag_embed(X.diagonal(0, -2, -1))
    return 2 * Lr.abs() @ phi


def _dense(diag, lower, sym):
    """(B, N n, N n) from diagonal blocks (B, N, n, n) and the blocks below
    them, lower[:, k] at block (k + 1, k); mirrored above when ``sym``."""
    import torch

    B, N, n, _ = diag.shape
    out = torch.zeros(B, N * n, N * n, dtype=diag.dtype, device=diag.device)
    for k in range(N):
        out[:, k * n:(k + 1) * n, k * n:(k + 1) * n] = diag[:, k]
        if k + 1 < N:
            out[:, (k + 1) * n:(k + 2) * n, k * n:(k + 1) * n] = lower[:, k]
            if sym:
                out[:, k * n:(k + 1) * n, (k + 1) * n:(k + 2) * n] = _T(lower[:, k])
    return out


def _blocks(X, N, n):
    """Diagonal blocks and the blocks below them of a dense (B, N n, N n)."""
    import torch

    d = torch.stack([X[:, k * n:(k + 1) * n, k * n:(k + 1) * n]
                     for k in range(N)], 1)
    low = torch.stack([X[:, (k + 1) * n:(k + 2) * n, k * n:(k + 1) * n]
                       for k in range(N - 1)], 1)
    return d, low


def _as_cols(L, b):
    """A vector right-hand side (..., n) as one column (..., n, 1)."""
    return b[..., None] if b.dim() == L.dim() - 1 else b


def _cho_den(args, x):
    """Residual of (L L') X = B (column by column) and its absolute-term
    scale; vector or matrix right-hand sides, returned as columns."""
    L, b = (t.double() for t in args)
    b, x = _as_cols(L, b), _as_cols(L, x.double())
    return (L @ (_T(L) @ x) - b,
            L.abs() @ (_T(L).abs() @ x.abs()) + b.abs())


def _backward_cho(args, outs):
    """Two triangular solves of n terms a row, evaluated with 2n + 1."""
    res, den = _cho_den(args, outs[0])
    return {"solve": (_omega(res, den), 2 * args[0].shape[-1] + 1)}


def _forward_cho(args, ref, outs, dtype):
    import torch

    L = args[0].double()
    n_t = 2 * L.shape[-1] + 1
    Ainv = torch.cholesky_inverse(L).abs()
    tol = Ainv @ (_gamma(n_t, dtype) * _cho_den(args, outs[0])[1]
                  + _gamma(n_t, torch.float64) * _cho_den(args, ref[0])[1])
    err = _as_cols(L, outs[0].double()) - _as_cols(L, ref[0].double())
    return _omega(err, tol)


# chol: Higham Thm 10.3, the computed factor of an n x n SPD A satisfies
# L L' = A + dA with |dA| <= gamma_{n+1} |L| |L'|. Only the lower triangle
# of A is read (the IPM's H is symmetric only to rounding).
def _backward_chol(args, outs):
    import torch

    A, L = args[0].double(), outs[0].double()
    res = torch.tril(L @ _T(L) - A)
    return {"factor": (_omega(res, L.abs() @ _T(L.abs())), A.shape[-1] + 1)}


def _forward_chol(args, ref, outs, dtype):
    Lr = ref[0].double()
    tol = _chol_forward(Lr, _both(Lr.shape[-1] + 1, dtype)
                        * (Lr.abs() @ _T(Lr.abs())))
    return _omega(outs[0].double() - Lr, tol)


def _guaranteed_chol(args, ref, dtype):
    """(N,) blocks that stay positive definite, with room for the forward
    bound, under every perturbation within the backward-error bound."""
    from successiveconvexification_tpu_torch.ops import smallla

    A, Lr = args[0].double(), ref[0].double()
    shift = 2 * _gamma(A.shape[-1] + 1, dtype) * (
        Lr.abs() @ _T(Lr.abs())).sum(-1).amax(-1)
    return _lane_finite((smallla.chol(A - shift[..., None, None]
                                      * _eye(A.shape[-1], A)),))


def _tridiag_den(args, u):
    """Residual of M u = r, M = Lb Lb' with Lb block lower bidiagonal (L_k
    on the diagonal, C_k' below it), and its absolute-term scale."""
    L, C, r = (t.double() for t in args)
    u = u.double()
    w, wa = _mv(_T(L), u), _mv(_T(L).abs(), u.abs())
    w[:, :-1] += _mv(C[:, 1:], u[:, 1:])
    wa[:, :-1] += _mv(C[:, 1:].abs(), u[:, 1:].abs())
    y, ya = _mv(L, w), _mv(L.abs(), wa)
    y[:, 1:] += _mv(_T(C[:, 1:]), w[:, :-1])
    ya[:, 1:] += _mv(_T(C[:, 1:]).abs(), wa[:, :-1])
    return y - r, ya + r.abs()


def _backward_tridiag(args, outs):
    """Each sweep's row has 2n terms; the evaluation 4n + 1."""
    res, den = _tridiag_den(args, outs[0])
    return {"solve": (_omega(res, den), 4 * args[0].shape[-1] + 1)}


def _forward_tridiag(args, ref, outs, dtype):
    import torch

    L, C = args[0].double(), args[1].double()
    B, N, n, _ = L.shape
    n_t = 4 * n + 1
    Lb = _dense(L, _T(C[:, 1:]), sym=False)
    Li = torch.linalg.solve_triangular(Lb, _eye(N * n, Lb), upper=False)
    Ainv = (_T(Li) @ Li).abs()
    den = (_gamma(n_t, dtype) * _tridiag_den(args, outs[0])[1]
           + _gamma(n_t, torch.float64) * _tridiag_den(args, ref[0])[1])
    tol = _mv(Ainv, den.reshape(B, N * n))
    return _omega((outs[0].double() - ref[0].double()).reshape(B, N * n), tol)


def _fused_terms(args, Lh):
    """What the fused factorization factors, formed in float64 from its
    inputs and a given chol_Hw, each beside the sum of the absolute values
    of its terms (the scale of the rounding any method commits on it).

    H_k: the kernel sums R + S + 1 terms, each with a factor u_s of up to m
    terms, then factors: N_h = R + S + 2m + 3. D_k, O_k: formed with X =
    H^-1 E', H^-1 F' solved from chol_Hw; a backward-stable solve has
    (H + dH) X = E', |dH| <= 2 gamma_nw |chol_Hw| |chol_Hw'|, so E X carries
    an error up to |X|' |dH| |X|, which joins the absolute terms of D and O
    (first order in u). With the block-tridiagonal step,
    N_s = 2 nw + 2 nrx + 3. Da_h, Oa_h carry H's own rounding (|dH| up to
    gamma_{N_h} |H's terms|) into D and O, for the forward bound."""
    import torch

    from successiveconvexification_tpu_torch.ops import smallla

    G, wrow, uv, ucoef, hdiag, E, F, dpq = (t.double() for t in args[:8])
    rng = args[8].tolist()
    Lh = Lh.double()
    nw, nrx, R = G.shape[-1], E.shape[-2], G.shape[-2]
    Ga = G.abs()
    H = torch.einsum("bkr,bkra,bkrc->bkac", wrow, G, G)
    Ha = torch.einsum("bkr,bkra,bkrc->bkac", wrow.abs(), Ga, Ga)
    m = 0
    for s, (o, e) in enumerate(rng):
        u = torch.einsum("bkr,bkra->bka", uv[..., o:e], G[..., o:e, :])
        ua = torch.einsum("bkr,bkra->bka", uv[..., o:e].abs(), Ga[..., o:e, :])
        H += ucoef[..., s, None, None] * u[..., :, None] * u[..., None, :]
        Ha += ucoef[..., s, None, None].abs() * ua[..., :, None] * ua[..., None, :]
        m = max(m, e - o)
    H += torch.diag_embed(hdiag)
    Ha += torch.diag_embed(hdiag.abs())
    HH = Lh.abs() @ _T(Lh.abs())
    XE = smallla.cho_solve(Lh[:, :-1], _T(E))       # H_k^-1 E_k'
    XF = smallla.cho_solve(Lh[:, 1:], _T(F))        # H_{k+1}^-1 F_k'
    XEa, XFa = XE.abs(), XF.abs()
    return dict(
        H=H, Ha=Ha, HH=HH,
        D=E @ XE + F @ XF + torch.diag_embed(dpq),
        Da=(E.abs() @ XEa + F.abs() @ XFa + torch.diag_embed(dpq.abs())
            + _T(XEa) @ HH[:, :-1] @ XEa + _T(XFa) @ HH[:, 1:] @ XFa),
        Da_h=_T(XEa) @ Ha[:, :-1] @ XEa + _T(XFa) @ Ha[:, 1:] @ XFa,
        O=F[:, :-1] @ XE[:, 1:],                   # O_k = F_k H_{k+1}^-1 E_{k+1}'
        Oa=(F[:, :-1].abs() @ XEa[:, 1:]
            + _T(XFa[:, :-1]) @ HH[:, 1:-1] @ XEa[:, 1:]),
        Oa_h=_T(XFa[:, :-1]) @ Ha[:, 1:-1] @ XEa[:, 1:],
        n_h=R + len(rng) + 2 * m + 3, n_s=2 * nw + 2 * nrx + 3)


def _schur_den(t, L, C, with_h=False):
    """Absolute-term scales of the block-tridiagonal system rebuilt from
    (L, C): D_k = L_k L_k' + C_k' C_k, O_k = L_k C_{k+1}."""
    den_d = L.abs() @ _T(L.abs()) + _T(C.abs()) @ C.abs() + t["Da"]
    den_o = L[:, :-1].abs() @ C[:, 1:].abs() + t["Oa"]
    if with_h:
        den_d, den_o = den_d + t["Da_h"], den_o + t["Oa_h"]
    return den_d, den_o


def _backward_fused(args, outs):
    """'hessian': chol_Hw chol_Hw' - H over |chol_Hw| |chol_Hw'| + |H's
    terms|; 'schur': the block-tridiagonal system rebuilt from the kernel's
    L, C against D, O formed from the kernel's OWN chol_Hw (_fused_terms)."""
    import torch

    Lh, L, C = (t.double() for t in outs)
    t = _fused_terms(args, Lh)
    om_h = _omega(Lh @ _T(Lh) - t["H"], t["HH"] + t["Ha"])
    den_d, den_o = _schur_den(t, L, C)
    om_s = _omega(L @ _T(L) + _T(C) @ C - t["D"], den_d)
    if t["O"].shape[1] > 0:
        om_s = torch.maximum(om_s, _omega(L[:, :-1] @ C[:, 1:] - t["O"], den_o))
    return {"hessian": (om_h, t["n_h"]), "schur": (om_s, t["n_s"])}


def _forward_fused(args, ref, outs, dtype):
    """chol_Hw moves with H's rounding; (L, C), the block Cholesky factor
    of the Schur system, with the Schur system's rounding and H's carried
    into D and O (N_h + N_s terms)."""
    import torch

    Lh_r, L_r, C_r = (t.double() for t in ref)
    Lh, L, C = (t.double() for t in outs)
    B, N, n, _ = L_r.shape
    t = _fused_terms(args, Lh_r)
    tol_h = _chol_forward(Lh_r, _both(t["n_h"], dtype) * (t["HH"] + t["Ha"]))
    den_d, den_o = _schur_den(t, L_r, C_r, with_h=True)
    tol = _chol_forward(_dense(L_r, _T(C_r[:, 1:]), sym=False),
                        _both(t["n_h"] + t["n_s"], dtype)
                        * _dense(den_d, _T(den_o), sym=True))
    tol_L, tol_Ct = _blocks(tol, N, n)
    tol_C = torch.cat([torch.zeros_like(tol_L[:, :1]), _T(tol_Ct)], 1)
    return torch.stack([_omega(Lh - Lh_r, tol_h), _omega(L - L_r, tol_L),
                        _omega(C - C_r, tol_C)]).amax(0)


def _guaranteed_fused(args, ref, dtype):
    """(B,) success with room for the forward bound, for every H_k and for
    the Schur system, in ``dtype``."""
    from successiveconvexification_tpu_torch.ops import smallla

    Lh, L, C = (t.double() for t in ref)
    t = _fused_terms(args, Lh)
    nw, nrx = Lh.shape[-1], L.shape[-1]
    shift_h = 2 * _gamma(t["n_h"], dtype) * (t["HH"] + t["Ha"]).sum(-1).amax(-1)
    ok_h = _lane_finite((smallla.chol(t["H"] - shift_h[..., None, None] * _eye(nw, Lh)),))
    den_d, den_o = _schur_den(t, L, C, with_h=True)
    rows = den_d.sum(-1)
    rows[:, :-1] += den_o.sum(-1)
    rows[:, 1:] += den_o.sum(-2)
    shift_s = 2 * _gamma(t["n_h"] + t["n_s"], dtype) * rows.amax((1, 2))
    Ls, _ = smallla.blocktridiag_factor(
        t["D"] - shift_s[:, None, None, None] * _eye(nrx, Lh), t["O"])
    return ok_h & _lane_finite((Ls,))


def _guaranteed_solve(args, ref, dtype):
    """(B,) the solves divide only by the diagonal of L: finite inputs and a
    finite reference give a finite result."""
    return _lane_finite([a for a in args if a.is_floating_point()]) & _lane_finite(ref)


BACKWARD = {"fused_factor": _backward_fused, "tridiag_solve": _backward_tridiag,
            "cho_solve_vec": _backward_cho, "chol": _backward_chol,
            "cho_solve": _backward_cho}
FORWARD = {"fused_factor": _forward_fused, "tridiag_solve": _forward_tridiag,
           "cho_solve_vec": _forward_cho, "chol": _forward_chol,
           "cho_solve": _forward_cho}
GUARANTEED = {"fused_factor": _guaranteed_fused,
              "tridiag_solve": _guaranteed_solve,
              "cho_solve_vec": _guaranteed_solve, "chol": _guaranteed_chol,
              "cho_solve": _guaranteed_solve}


def check_call(name, args, kernel, plain):
    """Hold one captured call of a kernel against its plain version.

    Runs the plain version in float64 (the reference) and float32 and the
    kernel in both dtypes on the same inputs. Fails (returns ok=False) if
    a kernel is non-finite in a lane where success in its dtype is
    guaranteed; if, in such a lane, its error against the reference exceeds
    the forward bound or a residual exceeds its backward bound. The plain
    float32 version losing a guaranteed lane fails it too: the guarantee
    would then be wrong. Readings are fractions of the bounds (<= 1)."""
    import torch

    def cast(dt):
        return [a.to(dt) if a.is_floating_point() else a for a in args]

    a32, a64 = cast(torch.float32), cast(torch.float64)
    ref, p32 = _tuple(plain(*a64)), _tuple(plain(*a32))
    k32, k64 = _tuple(kernel(*a32)), _tuple(kernel(*a64))
    fr, fp = _lane_finite(ref), _lane_finite(p32)
    fk32, fk64 = _lane_finite(k32), _lane_finite(k64)
    sure32 = GUARANTEED[name](a64, ref, torch.float32) & fr
    sure64 = GUARANTEED[name](a64, ref, torch.float64) & fr
    out = {"lanes": int(fr.numel()), "ref_finite": int(fr.sum()),
           "f32_guaranteed": int(sure32.sum()),
           "f64_guaranteed": int(sure64.sum()),
           "plain32_finite": int(fp.sum()), "kernel32_finite": int(fk32.sum()),
           "kernel64_finite": int(fk64.sum()),
           "kernel32_lost": int((sure32 & ~fk32).sum()),
           "plain32_lost": int((sure32 & ~fp).sum()),
           "kernel64_lost": int((sure64 & ~fk64).sum()),
           "max_abs_err": float((torch.cat([_lanes(k) for k in k32], 1)
                                 - torch.cat([_lanes(p) for p in p32], 1))
                                .abs().nan_to_num(0.0).max())}
    ok = (out["kernel32_lost"] == 0 and out["plain32_lost"] == 0
          and out["kernel64_lost"] == 0)
    for tag, ins, k, sure, plain_outs, dt in (
            ("f32", a32, k32, sure32 & fk32 & fp, p32, torch.float32),
            ("f64", a64, k64, sure64 & fk64, ref, torch.float64)):
        readings = {"fwd_kernel": FORWARD[name](a64, ref, k, dt)}
        if tag == "f32":
            readings["fwd_plain"] = FORWARD[name](a64, ref, plain_outs, dt)
        for who, outs in (("kernel", k), ("plain", plain_outs)):
            for part, (om, n_terms) in BACKWARD[name](ins, outs).items():
                readings[f"bwd_{part}_{who}"] = om / (2 * _gamma(n_terms, dt))
        for key, r in readings.items():
            val = float(r[sure].max()) if bool(sure.any()) else 0.0
            out[f"{key}_{tag}"] = val
            if "kernel" in key:
                ok &= val <= 1.0
    torch.cuda.synchronize()
    out["ok"] = bool(ok)
    return out


def _time_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around ``reps`` calls, after a
    warm-up. A spin kernel holds the stream while the host enqueues the
    calls, so the events time the device's work back to back and not the
    host's launch overhead (a ctypes launch costs tens of microseconds of
    host time, more than the smallest kernel here runs)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    fn()
    t_host = time.perf_counter() - t_host
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second: spin twice as long as the host needs to enqueue
    torch.cuda._sleep(int(min(2.0 * reps * t_host, 2.0) * 2e9))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _work(name: str, args, esize: int):
    """(bytes, flops) the function must move and compute on these inputs:
    every input read once, every output written once. ``chol`` reads only
    the lower triangle of each A block and the solves only that of each L
    block, so only it counts."""
    if name == "fused_factor":
        G, wrow, uv, ucoef, hdiag, E, F, dpq, rng = args
        B, K, R, nw = G.shape
        nrx, S = E.shape[2], ucoef.shape[-1]
        elems = (G.numel() + wrow.numel() + uv.numel() + ucoef.numel()
                 + hdiag.numel() + E.numel() + F.numel() + dpq.numel()
                 + B * K * nw * nw + 2 * B * (K - 1) * nrx * nrx)
        r_soc = int((rng[:, 1] - rng[:, 0]).sum())
        low_w, low_x = nw * (nw + 1) // 2, nrx * (nrx + 1) // 2
        per_node = (2 * r_soc * nw + low_w * (3 * R + 3 * S) + nw ** 3 / 3
                    + 4 * nrx * nw * nw)
        per_block = (6 * nrx * nrx * nw + nrx ** 3 + 2 * nrx * low_x
                     + nrx ** 3 / 3)
        flops = B * (K * per_node + (K - 1) * per_block)
        return elems * esize + rng.numel() * 4, flops
    if name == "tridiag_solve":
        L, C, r = args
        B, N, n, _ = L.shape
        low = B * N * n * (n + 1) // 2
        return (low + C.numel() + 2 * r.numel()) * esize, 6 * B * N * n * n
    if name == "chol":      # reads A's lower triangle, writes all of L
        (A,) = args
        n = A.shape[-1]
        N = A.numel() // (n * n)
        return (N * n * (n + 1) // 2 + A.numel()) * esize, N * n ** 3 / 3
    L, b = args       # cho_solve_vec, cho_solve: 2 n^2 flops a column
    n = L.shape[-1]
    N = L.numel() // (n * n)
    return (N * n * (n + 1) // 2 + 2 * b.numel()) * esize, 2 * n * b.numel()


def _time_kernel(name, args, kernel, plain, library):
    """Device ms of the kernel, its plain version and the library call (or
    None), and the bound for this call's work."""
    ms = _time_ms(lambda: kernel(*args))
    # few reps: the plain versions launch hundreds of small kernels a call,
    # and the stream's queue must hold them all while held
    plain_ms = _time_ms(lambda: plain(*args), reps=2)
    lib_ms = None if library is None else _time_ms(lambda: library(*args))
    nbytes, flops = _work(name, args, args[0].element_size())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return ms, plain_ms, lib_ms, {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, "mbytes": nbytes / 1e6, "gflop": flops / 1e9}


def _blockwise(args):
    """A call's tensors with every leading axis folded into one block axis,
    so the checks see each block as a lane."""
    return tuple(a.reshape(-1, *a.shape[-2:]) for a in args)


def profile_iteration(P, model, cfg, r) -> dict:
    """One warm replan iteration (from the warm-started state) under
    torch.profiler: the device operations (kernels, copies, sets), the
    union of their intervals, and the aten operator calls (nested
    included), counted as scripts/profile_torch_iteration.py counts."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from profile_torch_iteration import device_busy_ms

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        P.scvx_iteration(model, r["params"], cfg, r["warm0"])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise PhaseError("profile: the trace holds no device events")
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    return {"wall_ms": wall, "device_ops": len(dev),
            "busy_ms": device_busy_ms(dev)[0],
            "aten_calls": sum(e.count for e in ops)}


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi failed"


# ---------------------------------------------------------------- phases
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        P, _build, cuda_fused, cuda_kkt = _import_port()
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from successiveconvexification_tpu_torch.parallel import batch as batch_mod
    from successiveconvexification_tpu_torch.ops import precision

    precision.full_precision()
    children = []
    ref_path = os.path.join(ROOT, "build", "chip_smoke_cpu_reference.json")
    replan_path = os.path.join(ROOT, "build", "chip_smoke_cpu_replan.json")
    try:
        # ---- 1. card and build ------------------------------------------------
        card = _card_line()
        print(card)
        kind = torch.cuda.get_device_name(0)
        print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build: {time.perf_counter() - t0:.1f} s for "
              f"{', '.join(s + '.cu' for s in _build.SOURCES)} (parallel nvcc)")
        for src in _build.SOURCES:
            log = os.path.join(_build.BUILD, f"{src}.log")
            if os.path.exists(log):
                for line in open(log):
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas {src}: {line.strip()}")

        # ---- 2. the main path ----------------------------------------------
        model = P.rocket6dof_model()
        cfg = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True)
        pb = _dispersed(P, MAIN_B, torch.float32, "cuda")
        counts = {"lockstep": 0, "cold": 0}
        orig_iter = batch_mod.scvx_iteration

        def counting_iteration(model_, params_, cfg_, st_, assume_warm_valid=False):
            counts["lockstep"] += 1
            counts["cold"] += 0 if assume_warm_valid else 1
            if counts["lockstep"] == LATE_LOCKSTEP:
                for c in caps.values():
                    c.recent.clear()
            out_ = orig_iter(model_, params_, cfg_, st_,
                             assume_warm_valid=assume_warm_valid)
            if counts["lockstep"] == LATE_LOCKSTEP:
                for c in caps.values():
                    c.late = list(c.recent)
            return out_

        wrappers = {"fused_factor": cuda_fused.fused_factor,
                    "tridiag_solve": cuda_kkt.tridiag_solve,
                    "cho_solve_vec": cuda_kkt.cho_solve_vec}
        caps = {
            "fused_factor": Capture(cuda_fused, "fused_factor",
                                    PER_COLD["fused_factor"]),
            "tridiag_solve": Capture(cuda_kkt, "tridiag_solve",
                                     PER_COLD["tridiag_solve"]),
            "cho_solve_vec": Capture(cuda_kkt, "cho_solve_vec",
                                     PER_COLD["cho_solve_vec"]),
        }
        batch_mod.scvx_iteration = counting_iteration
        try:
            with caps["fused_factor"], caps["tridiag_solve"], caps["cho_solve_vec"]:
                for w in wrappers.values():
                    w.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = P.solve_batch_compact_device(model, pb, cfg, chunk=10,
                                                   min_bucket=32, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: w.launches for k, w in wrappers.items()}
        finally:
            batch_mod.scvx_iteration = orig_iter

        for c in caps.values():
            c.late = list(c.recent) if c.late is None else c.late
        finite = all(bool(torch.isfinite(t).all()) for t in (out.X, out.U, out.sigma))
        shapes = (tuple(out.X.shape) == (MAIN_B, MAIN_K, 14)
                  and tuple(out.U.shape) == (MAIN_B, MAIN_K, 3))
        n_conv = int(out.converged.sum())
        its = sorted(out.iterations.tolist())
        pct = lambda q: its[min(len(its) - 1, int(math.ceil(q * len(its))) - 1)]  # noqa: E731
        feas = (out.defect_nl + out.viol_nl)[out.converged]
        ms_iter = 1e3 * wall / max(counts["lockstep"], 1)
        print(f"main path: B={MAIN_B} K={MAIN_K} substeps={MAIN_SUBSTEPS} float32: "
              f"{n_conv}/{MAIN_B} converged, iterations p50 {pct(0.5)} p90 "
              f"{pct(0.9)} max {its[-1]}, wall {wall:.3f} s, "
              f"{counts['lockstep']} lockstep SCvx iterations "
              f"({counts['cold']} with a cold init), {ms_iter:.2f} ms per "
              f"SCvx iteration, sigma mean {float(out.sigma.mean()):.4f}, "
              f"max converged defect+violation {float(feas.max()) if n_conv else float('nan'):.3e}")
        print(f"main path launches: {json.dumps(launches)}")
        n_body = launches["fused_factor"] - counts["cold"]
        expect = {k: PER_ITER[k] * n_body + PER_COLD[k] * counts["cold"]
                  for k in launches}
        print(f"  expected from {n_body} IPM iterations + {counts['cold']} cold "
              f"inits: {json.dumps(expect)}")
        if not (finite and shapes):
            raise PhaseError("main path: non-finite or misshapen trajectories")
        if n_conv < MAIN_B // 2:
            raise PhaseError(f"main path: only {n_conv}/{MAIN_B} lanes converged")
        if any(v == 0 for v in launches.values()):
            raise PhaseError(f"main path: a kernel never launched: {launches}")
        if launches != expect:
            raise PhaseError("main path: launch counts do not match the IPM")

        # ---- 2b. the replan path ---------------------------------------------
        wrappers.update(chol=cuda_kkt.chol, cho_solve=cuda_kkt.cho_solve)
        rcaps = {"chol": Capture(cuda_kkt, "chol", REPLAN_PER_COLD["chol"]),
                 "cho_solve": Capture(cuda_kkt, "cho_solve",
                                      REPLAN_PER_COLD["cho_solve"])}
        # bench.py's settings: the latency readings, the kernels' inputs
        cfg_r = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True,
                         kkt="pcr")
        with rcaps["chol"], rcaps["cho_solve"]:
            r, rlaunches = run_replan(P, batch_mod, model, cfg_r, wrappers,
                                      rcaps, BENCH_REPLAN_ITERS, card)
        if not r["summary"]["cold_converged"]:
            raise PhaseError("replan path: the cold solve did not converge")
        if not r["summary"]["converged"]:
            print(f"  the replan did not re-converge within bench.py's "
                  f"{BENCH_REPLAN_ITERS} iterations at the default static_reg "
                  "(REPLAN_CHECK_REG, ROADMAP Queue 3: the PCR solves of the "
                  "f32 IPM end uncertified, the summation order decides the "
                  "path, and the plain versions stick too); the run at "
                  f"{REPLAN_CHECK_REG:g} holds the re-convergence")
        busy = profile_iteration(P, model, cfg_r, r)
        print(f"one warm replan iteration under torch.profiler: wall "
              f"{busy['wall_ms']:.1f} ms, {busy['device_ops']} device "
              f"operations, device busy {busy['busy_ms']:.1f} ms "
              f"({100 * busy['busy_ms'] / busy['wall_ms']:.1f}% of the wall), "
              f"{busy['aten_calls']} aten operator calls (nested included)")
        # the same path at static_reg 1e-6 and bench.py's cap: both solves
        # must converge
        cfg_r6 = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True,
                          kkt="pcr", static_reg=REPLAN_CHECK_REG)
        r6, _ = run_replan(P, batch_mod, model, cfg_r6, wrappers, {},
                           BENCH_REPLAN_ITERS, card)
        if not (r6["summary"]["cold_converged"] and r6["summary"]["converged"]):
            raise PhaseError(f"replan path at static_reg {REPLAN_CHECK_REG:g}: "
                             "a solve did not converge")

        # the CPU halves of phase 4 run beside phases 3 and 5 (not beside the
        # host-bound paths above, whose walls they would inflate)
        for path in (ref_path, replan_path):
            if os.path.exists(path):
                os.remove(path)
        children = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, path], cwd=ROOT)
            for mode, path in (("--cpu-reference", ref_path),
                               ("--cpu-replan", replan_path))]

        # ---- 3. kernels against their plain versions ---------------------------
        plains = {"fused_factor": cuda_fused.fused_factor_plain,
                  "tridiag_solve": cuda_kkt.tridiag_solve_plain,
                  "cho_solve_vec": cuda_kkt.cho_solve_vec_plain,
                  "chol": cuda_kkt.chol_plain,
                  "cho_solve": cuda_kkt.cho_solve_plain}
        # chol and cho_solve run on one lane: hold them block by block
        for c in rcaps.values():
            c.first = _blockwise(c.first)
            c.late = [_blockwise(a) for a in c.late]
        print("checks: readings are fractions of their bounds (<= 1), the "
              "largest over the calls and over the lanes where success in the "
              "dtype is guaranteed")
        max_abs, all_checks, failed = {}, {}, []
        phases = [(name, cap, "first IPM iteration",
                   f"SCvx iteration {LATE_LOCKSTEP}") for name, cap in caps.items()]
        phases += [(name, cap, "first IPM iteration of the cold replan solve",
                    "last replan iteration") for name, cap in rcaps.items()]
        for name, cap, first_when, late_when in phases:
            # every call of the late iteration, but every fourth for the
            # main path's solves (their dense forward bounds are costly)
            late = cap.late[::4] if name in ("tridiag_solve", "cho_solve_vec") \
                else cap.late
            for when, calls in ((first_when, [cap.first]), (late_when, late)):
                if not calls or calls[0] is None:
                    raise PhaseError(f"{name}: no captured call for {when}")
                before = wrappers[name].launches
                res = [check_call(name, a, wrappers[name], plains[name])
                       for a in calls]
                if wrappers[name].launches != before + 2 * len(calls):
                    raise PhaseError(f"{name}: a kernel call did not count one launch")
                all_checks[f"{name} / {when}"] = res
                if when == first_when:
                    max_abs[name] = res[0]["max_abs_err"]
                top = lambda key: max(r[key] for r in res)  # noqa: E731
                tot = lambda key: sum(r[key] for r in res)  # noqa: E731
                reads = "; ".join(f"{key} {top(key):.3f}" for key in res[0]
                                  if key.startswith(("fwd_", "bwd_")))
                n_bad = sum(not r["ok"] for r in res)
                print(f"check {name} ({when}, {len(res)} call(s) of "
                      f"{res[0]['lanes']} lanes, shapes "
                      f"{[tuple(a.shape) for a in calls[0]]}): lane-calls with "
                      f"the reference finite {tot('ref_finite')}, success "
                      f"guaranteed f32 {tot('f32_guaranteed')} / f64 "
                      f"{tot('f64_guaranteed')}; finite in plain f32 "
                      f"{tot('plain32_finite')}, kernel f32 "
                      f"{tot('kernel32_finite')}, kernel f64 "
                      f"{tot('kernel64_finite')}; guaranteed lanes lost by the "
                      f"kernel f32 {tot('kernel32_lost')} (by plain f32 "
                      f"{tot('plain32_lost')}), by the kernel f64 "
                      f"{tot('kernel64_lost')}; {reads} -> "
                      f"{'ok' if n_bad == 0 else f'FAIL in {n_bad}'}")
                if n_bad:
                    failed.append(f"{name} ({when})")
        with open(os.path.join(ROOT, "build", "chip_smoke_checks.json"), "w") as f:
            json.dump(all_checks, f)
        if failed:
            raise PhaseError(f"kernels disagree with their plain versions: {failed}")

        # the wrappers refuse what their kernels do not take
        dev = "cuda"
        refusals = (
            ("float16", TypeError, lambda: cuda_kkt.cho_solve_vec(
                torch.eye(4, dtype=torch.float16, device=dev).expand(2, 4, 4),
                torch.zeros(2, 4, dtype=torch.float16, device=dev))),
            ("n = 40 > 32", ValueError, lambda: cuda_kkt.cho_solve_vec(
                torch.eye(40, dtype=torch.float64, device=dev)[None],
                torch.zeros(1, 40, dtype=torch.float64, device=dev))),
            ("CPU and CUDA tensors mixed", ValueError, lambda: cuda_kkt.tridiag_solve(
                torch.eye(3, device=dev).expand(1, 2, 3, 3),
                torch.zeros(1, 2, 3, 3), torch.zeros(1, 2, 3, device=dev))),
            ("chol float16", TypeError, lambda: cuda_kkt.chol(
                torch.eye(4, dtype=torch.float16, device=dev)[None])),
            ("chol n = 33 > 32", ValueError, lambda: cuda_kkt.chol(
                torch.eye(33, device=dev)[None])),
            ("cho_solve m = 33 > 32", ValueError, lambda: cuda_kkt.cho_solve(
                torch.eye(4, device=dev)[None], torch.zeros(1, 4, 33, device=dev))),
            ("cho_solve CPU and CUDA tensors mixed", ValueError,
             lambda: cuda_kkt.cho_solve(torch.eye(4, device=dev)[None],
                                        torch.zeros(1, 4, 3))),
        )
        for what, exc, call in refusals:
            try:
                call()
            except exc:
                continue
            raise PhaseError(f"a wrapper took what its kernel does not ({what})")
        print(f"wrappers refuse: {', '.join(w for w, _, _ in refusals)} -> ok")

        # ---- 5. times at each path's shapes -----------------------------------
        library = {
            "cho_solve_vec": lambda L, b: torch.cholesky_solve(b[..., None], L),
            "chol": lambda A: torch.linalg.cholesky_ex(A),
            "cho_solve": lambda L, B: torch.cholesky_solve(B, L)}
        records = []
        timed = [(name, cap.first, launches[name], "main path")
                 for name, cap in caps.items()]
        timed += [(name, cap.first, rlaunches[name], "replan path")
                  for name, cap in rcaps.items()]
        # chol and cho_solve also at a B=256 batch of the replan blocks
        timed += [(name, tuple(a.repeat(MAIN_B, *([1] * (a.dim() - 1)))
                               for a in cap.first), None, "B=256 batch")
                  for name, cap in rcaps.items()]
        for name, args, n_launch, where in timed:
            ms, plain_ms, lib_ms, rec = _time_kernel(
                name, args, wrappers[name], plains[name], library.get(name))
            if n_launch is not None:
                records.append({"name": name, "route": "cuda", **KERNELS[name],
                                "launches": n_launch,
                                "max_abs_err": max_abs[name],
                                **{k: v for k, v in rec.items()
                                   if k not in ("mbytes", "gflop")}})
            print(f"time {name} ({where}) at {[tuple(a.shape) for a in args]}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                  f"{rec['bound_ms']:.5f} ms by {rec['bound_by']} "
                  f"({rec['mbytes']:.3f} MB, {rec['gflop']:.5f} GFLOP); {card}")

        # ---- 4. f64 on the card against the CPU -------------------------------
        cfg64 = _configs(P, "float64", MAIN_K, MAIN_SUBSTEPS, bench=False)
        pb64 = _dispersed(P, REF_B, torch.float64, "cuda")
        t0 = time.perf_counter()
        st64 = P.solve_batch(model, pb64, cfg64, device="cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        cfg64r = _configs(P, "float64", MAIN_K, MAIN_SUBSTEPS, bench=False,
                          kkt="pcr", static_reg=REPLAN_CHECK_REG)
        t0 = time.perf_counter()
        card_r = _replan_summary(replan(P, model, cfg64r, "cuda",
                                        cfg64r.scvx.max_iters))
        card_r_s = time.perf_counter() - t0
        rcs = [c.wait(timeout=900) for c in children]
        children = []
        if any(rcs) or not (os.path.exists(ref_path) and os.path.exists(replan_path)):
            raise PhaseError(f"f64 CPU reference runs failed (rc={rcs})")
        cpu = json.load(open(ref_path))
        cpu_r = json.load(open(replan_path))
        sig_card = st64.sigma.cpu().tolist()
        rel = max(abs(a - b) / abs(b) for a, b in zip(sig_card, cpu["sigma"]))
        same_its = st64.iterations.cpu().tolist() == cpu["iterations"]
        same_conv = st64.converged.cpu().tolist() == cpu["converged"]
        print(f"f64 B={REF_B} K={MAIN_K}: card {card_s:.1f} s, CPU "
              f"{cpu['seconds']:.1f} s; iterations card "
              f"{st64.iterations.cpu().tolist()} CPU {cpu['iterations']}; "
              f"converged {st64.converged.cpu().tolist()}; sigma max rel diff "
              f"{rel:.3e} (tol 1e-6)")
        if not (rel <= 1e-6 and same_its and same_conv):
            raise PhaseError("f64 card run disagrees with the CPU run")
        rel_r = max(abs(card_r[k] - cpu_r[k]) / abs(cpu_r[k])
                    for k in ("cold_sigma", "sigma"))
        same_r = all(card_r[k] == cpu_r[k] for k in (
            "cold_iterations", "cold_converged", "iterations", "converged"))
        print(f"f64 replan K={MAIN_K} PCR, static_reg {REPLAN_CHECK_REG:g}: card "
              f"{card_r_s:.1f} s, CPU "
              f"{cpu_r['seconds']:.1f} s; cold iterations card "
              f"{card_r['cold_iterations']} CPU {cpu_r['cold_iterations']}, "
              f"replan iterations card {card_r['iterations']} CPU "
              f"{cpu_r['iterations']}; converged card "
              f"{card_r['cold_converged']}/{card_r['converged']} CPU "
              f"{cpu_r['cold_converged']}/{cpu_r['converged']}; sigma max rel "
              f"diff {rel_r:.3e} (tol 1e-6)")
        if not (rel_r <= 1e-6 and same_r):
            raise PhaseError("f64 card replan disagrees with the CPU replan")

        print(json.dumps({"kernels": records}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--cpu-reference":
        cpu_reference(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--cpu-replan":
        cpu_replan(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
