"""Batched primal-dual interior-point SOCP solver (PyTorch port).

The counterpart of the JAX package's ``ops/ipm.py``: Nesterov-Todd scaling,
Mehrotra predictor-corrector, and a KKT solve specialized to the stage
structure of ``StageSOCP``:

    [ P   A'  G' ] [ux]   [bx]
    [ A   0   0  ] [uy] = [by]
    [ G   0 -W'W ] [uz]   [bz]

  1. uz = W^-2 (G ux - bz)  ->  H ux + A'uy = bx + G'W^-2 bz, H block-diagonal;
  2. Schur onto y: M uy = A H^-1 bxt - by, M block-tridiagonal plus a
     rank-one arrow from dsigma (Sherman-Morrison);
  3. block-tridiagonal Cholesky along K.

Where the JAX package wrote one scenario and let ``vmap`` add the batch,
every tensor here has the scenario axis 0, scenario-wide reductions are
per-lane ``(B,)`` tensors, and the per-lane ``lax.while_loop`` is a Python
loop whose finished lanes are frozen by ``torch.where`` (the select a
batched ``while_loop`` applies), so results do not depend on the batch.

Two factorization routes are ported (``factorize``), each with CUDA
kernels on the card and their plain PyTorch versions on the CPU:

  * ``kkt_solver="scan"`` (the batched sweep): the whole KKT factor in one
    ``cuda_fused.fused_factor``, the block-tridiagonal solves in
    ``cuda_kkt.tridiag_solve``;
  * ``kkt_solver="pcr"`` (single-lane replanning): H built here
    (``build_H``), factored by ``cuda_kkt.chol``, H^-1 E', H^-1 F' by
    ``cuda_kkt.cho_solve``, and the block-tridiagonal Schur system by
    parallel cyclic reduction (``_pcr_factor`` / ``_pcr_solve``, plain
    ``torch.linalg`` like the JAX package's XLA ``smallla`` there, but
    always in float64, where the JAX package reduces in the problem's
    dtype: see ``_pcr_factor``).

Both solve the stage Hessian with ``cuda_kkt.cho_solve_vec``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from successiveconvexification_tpu_torch.config import IPMConfig
from successiveconvexification_tpu_torch.ops import cones as C
from successiveconvexification_tpu_torch.ops import cuda_fused, cuda_kkt
from successiveconvexification_tpu_torch.ops import equilibrate as equilibrate_mod
from successiveconvexification_tpu_torch.ops import smallla, socp
from successiveconvexification_tpu_torch.ops.cones import lane, lane_sum
from successiveconvexification_tpu_torch.ops.socp import Primal, StageSOCP
from successiveconvexification_tpu_torch.utils.tree import tree_leaves, tree_where

ConeVec = Dict[str, torch.Tensor]

_NO_KSHARDED = ("the cross-device 'ksharded' KKT backend is not ported yet "
                "(ROADMAP.md Queue 1 item 8, multi-device)")
_NO_SCAN_R1 = ("the unfused 'scan' factorization (rank-one quadratic rows "
               "Q_r1) needs the block-tridiagonal factor kernel, not ported "
               "yet (ROADMAP.md Queue 2, kernel 5 tridiag_factor); use "
               "kkt_solver='pcr'")


class KKTFactors(NamedTuple):
    chol_Hw: torch.Tensor    # (B, K, nw, nw)
    d_p: torch.Tensor        # (B, K-1, nrx)
    d_q: torch.Tensor        # (B, K-1, nrx)
    h_sig: torch.Tensor      # (B,)
    tri: tuple               # "scan": (L, C), each (B, K-1, nrx, nrx);
                             # "pcr": (levels, chol_final), _pcr_factor
    sm_t: torch.Tensor       # (B, K-1, nrx)  M0^-1 g
    sm_denom: torch.Tensor   # (B,)           h_sig + g' M0^-1 g


def _spec_of(d: StageSOCP) -> Dict[str, str]:
    spec = {"lin": "lin", "pq": "lin", "sig": "lin"}
    for i in range(len(d.G_socs) - 1):
        spec[f"soc{i}"] = "soc"
    spec["tr"] = "soc"
    return spec


def build_H(d: StageSOCP, W, reg: float):
    """Stage Hessian blocks H = P + G'W^-2 G (B, K, nw, nw) and the p/q/sigma
    diagonal pieces."""
    wt = C.winv2_terms(_spec_of(d), W)
    GT = d.G_lin.transpose(-1, -2)
    H = GT @ (wt["lin"]["d"][..., None] * d.G_lin)
    for i, G in enumerate(d.G_socs):
        key = "tr" if i == len(d.G_socs) - 1 else f"soc{i}"
        coef = wt[key]["coef"]                                   # (B, K)
        u = (G.transpose(-1, -2) @ wt[key]["v"][..., None])      # G'v (B, K, nw, 1)
        jd = -torch.ones(G.shape[-2], dtype=G.dtype, device=G.device)
        jd[0] = 1.0                                              # J = diag(1, -I)
        GJG = G.transpose(-1, -2) @ (jd[:, None] * G)
        H = H + coef[..., None, None] * (2.0 * u @ u.transpose(-1, -2) - GJG)
    H = H + torch.diag_embed((1.0 - d.free_w) + d.Q_w + reg)
    if d.Q_r1.shape[2]:
        H = H + d.Q_r1.transpose(-1, -2) @ d.Q_r1
    d_p, d_q, h_sig = _pq_sig_terms(d, W, reg)
    return H, d_p, d_q, h_sig


def _pq_sig_terms(d: StageSOCP, W, reg: float):
    """The non-w diagonal H pieces (p/q/sigma)."""
    wt = C.winv2_terms(_spec_of(d), W)
    nx = d.c_p.shape[-1]
    dpq = wt["pq"]["d"]
    d_p = dpq[..., :nx] + reg
    d_q = dpq[..., nx:] + reg
    dsig = wt["sig"]["d"]
    h_sig = (torch.sum(d.G_sig * dsig * d.G_sig, dim=-1) + (1.0 - d.free_sig)
             + d.Q_sig + reg)
    return d_p, d_q, h_sig


def _fused_factor_inputs(d: StageSOCP, W, reg: float):
    """Per-row H weights for the fused factor: H = sum_r wrow_r g_r g_r'
    + sum_cones ucoef (G'uv)(G'uv)' + diag(hdiag)."""
    wt = C.winv2_terms(_spec_of(d), W)
    Bn, K = d.c_w.shape[:2]
    dtype, device = d.c_w.dtype, d.c_w.device
    nl = d.G_lin.shape[2]
    wrows = [wt["lin"]["d"]]
    uvs = [torch.zeros((Bn, K, nl), dtype=dtype, device=device)]
    ucs, ranges = [], []
    off = nl
    for i, G in enumerate(d.G_socs):
        key = "tr" if i == len(d.G_socs) - 1 else f"soc{i}"
        coef = wt[key]["coef"]
        dim = G.shape[2]
        jd = torch.ones(dim, dtype=dtype, device=device)
        jd[0] = -1.0
        wrows.append(coef[..., None] * jd)
        uvs.append(wt[key]["v"])
        ucs.append(2.0 * coef)
        ranges.append((off, off + dim))
        off += dim
    G_cat = torch.cat([d.G_lin, *d.G_socs], dim=2)
    wrow = torch.cat(wrows, dim=2)
    uv = torch.cat(uvs, dim=2)
    ucoef = torch.stack(ucs, dim=-1)
    hdiag = (1.0 - d.free_w) + d.Q_w + reg
    return G_cat, wrow, uv, ucoef, hdiag, tuple(ranges)


@functools.lru_cache(maxsize=16)
def _ranges_tensor(ranges: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(ranges, dtype=torch.int32, device=device)


def factorize(d: StageSOCP, W, cfg: IPMConfig) -> KKTFactors:
    if cfg.kkt_solver == "ksharded":
        raise NotImplementedError(_NO_KSHARDED)
    if cfg.kkt_solver == "pcr":
        return _factorize_unfused(d, W, cfg)
    if cfg.kkt_solver != "scan":
        raise ValueError(f"unknown kkt_solver {cfg.kkt_solver!r}")
    if d.Q_r1.shape[2]:
        raise NotImplementedError(_NO_SCAN_R1)
    nx = d.c_p.shape[-1]
    reg = cfg.static_reg

    d_p, d_q, h_sig = _pq_sig_terms(d, W, reg)
    G_cat, wrow, uv, ucoef, hdiag, ranges = _fused_factor_inputs(d, W, reg)
    diag_pq = torch.cat([1.0 / d_p + 1.0 / d_q,
                         torch.zeros_like(d.b[..., nx:])], dim=-1)
    diag_pq = diag_pq + (1.0 - d.eq_row_free) + reg
    chol_Hw, Ltri, Ctri = cuda_fused.fused_factor(
        G_cat, wrow, uv, ucoef, hdiag, d.E, d.F, diag_pq,
        _ranges_tensor(ranges, d.c_w.device))
    return _with_sherman_morrison(d, cfg, chol_Hw, d_p, d_q, h_sig,
                                  (Ltri, Ctri))


def _factorize_unfused(d: StageSOCP, W, cfg: IPMConfig) -> KKTFactors:
    """H built and factored block by block, the Schur system M = A H^-1 A'
    formed with matrix products and factored by PCR (``kkt_solver="pcr"``)."""
    nx = d.c_p.shape[-1]
    reg = cfg.static_reg
    H, d_p, d_q, h_sig = build_H(d, W, reg)
    chol_Hw = cuda_kkt.chol(H)
    # Hw^-1 E', Hw^-1 F'  (E_k on w_k, F_k on w_{k+1})
    XE = cuda_kkt.cho_solve(chol_Hw[:, :-1], d.E.transpose(-1, -2))
    XF = cuda_kkt.cho_solve(chol_Hw[:, 1:], d.F.transpose(-1, -2))
    # the virtual-control diagonal lives on the nx dynamics rows only;
    # pinned (structurally zero) tangent rows get a unit diagonal
    diag_pq = torch.cat([1.0 / d_p + 1.0 / d_q,
                         torch.zeros_like(d.b[..., nx:])], dim=-1)
    diag_pq = diag_pq + (1.0 - d.eq_row_free) + reg
    D = d.E @ XE + d.F @ XF + torch.diag_embed(diag_pq)
    O = d.F[:, :-1] @ XE[:, 1:]      # M[k, k+1] = F_k Hw_{k+1}^-1 E_{k+1}'
    return _with_sherman_morrison(d, cfg, chol_Hw, d_p, d_q, h_sig,
                                  _pcr_factor(D, O))


def _with_sherman_morrison(d, cfg, chol_Hw, d_p, d_q, h_sig, tri) -> KKTFactors:
    """The factors plus the rank-one sigma arrow's Sherman-Morrison data."""
    g = d.g_sig
    t = _tri_solve(cfg, tri, g)
    sm_denom = h_sig + lane_sum(g * t)
    return KKTFactors(chol_Hw=chol_Hw, d_p=d_p, d_q=d_q, h_sig=h_sig,
                      tri=tri, sm_t=t, sm_denom=sm_denom)


def _tri_solve(cfg: IPMConfig, tri, rhs):
    if cfg.kkt_solver == "pcr":
        return _pcr_solve(tri, rhs)
    L, Coff = tri
    return cuda_kkt.tridiag_solve(L, Coff, rhs)


def _shift_up(a: torch.Tensor, k: int, fill: torch.Tensor | None = None):
    """a[:, i + k] along axis 1, the last k entries ``fill`` (default 0)."""
    N = a.shape[1]
    pad = min(k, N)
    tail = (torch.zeros_like(a[:, :pad]) if fill is None
            else fill.expand(a[:, :pad].shape))
    return torch.cat([a[:, k:], tail], dim=1)


def _shift_down(a: torch.Tensor, k: int):
    """a[:, i - k] along axis 1, the first k entries 0."""
    N = a.shape[1]
    if k >= N:
        return torch.zeros_like(a)
    return torch.cat([torch.zeros_like(a[:, :k]), a[:, :-k]], dim=1)


def _pcr_factor(D: torch.Tensor, O: torch.Tensor):
    """``_pcr_reduce`` in float64 whatever the system's dtype (the factors
    are float64; ``_pcr_solve`` answers in the rhs's dtype). PCR is not
    backward stable: on an SPD block-tridiagonal system of condition 4e11
    its normwise residual is 5e-8 in float64, the block Cholesky sweep's
    1e-17. In float32 that error swamps the IPM's tolerances, late
    subproblems of the replan path return steps worse than none, and the
    f32 replan on the H100 stuck for a third to a half of the moves of
    r_init; with the reduction in float64 it re-converged for every one
    (PERF.md section 6). A float64 system is reduced as before."""
    return _pcr_reduce(D.double(), O.double())


def _pcr_solve(factors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve with ``_pcr_factor``'s factors; rhs (B, N, n) or (B, N, n, m)
    of any dtype, solved in float64 and answered in its own."""
    return _pcr_back(factors, rhs.double()).to(rhs.dtype)


def _pcr_reduce(D: torch.Tensor, O: torch.Tensor):
    """Parallel cyclic reduction of an SPD block-tridiagonal system along
    axis 1: log2(N) levels of batched small-block algebra instead of an
    N-step sequential sweep. D (B, N, n, n), O (B, N-1, n, n).

    Returns the per-level (chol_D, C, stride) and the final decoupled
    chol_D. With stride s = 2^l and C_i coupling i -> i+s:
        D'_i = D_i - C_{i-s}' D_{i-s}^-1 C_{i-s} - C_i D_{i+s}^-1 C_i'
        C'_i = -C_i D_{i+s}^-1 C_{i+s}          (couples i -> i+2s)
    """
    N, n = D.shape[1], D.shape[-1]
    levels = max(1, math.ceil(math.log2(max(N, 2))))
    C = torch.cat([O, torch.zeros_like(D[:, :1])], dim=1)   # C_i: i -> i+1
    eye = torch.eye(n, dtype=D.dtype, device=D.device)
    lev_data = []
    s = 1
    for _ in range(levels):
        cholD = smallla.chol(D)
        lev_data.append((cholD, C, s))
        DinvC = smallla.cho_solve(cholD, C)                  # D_i^-1 C_i
        # C_i = 0 wherever i+s is out of range (inductively), so the
        # identity padding is only a nonsingular placeholder
        tmp = smallla.cho_solve(_shift_up(cholD, s, eye),
                                C.transpose(-1, -2))         # D_{i+s}^-1 C_i'
        term_lo = _shift_down(C, s).transpose(-1, -2) @ _shift_down(DinvC, s)
        D = D - term_lo - C @ tmp
        C = -(C @ _shift_up(DinvC, s))
        s *= 2
    return lev_data, smallla.chol(D)


def _pcr_back(factors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve with ``_pcr_reduce``'s factors, in their dtype; rhs (B, N, n)
    or (B, N, n, m)."""
    lev_data, chol_final = factors
    vec = rhs.dim() == 3
    r = rhs[..., None] if vec else rhs
    for cholD, C, s in lev_data:
        Dinv_r = smallla.cho_solve(cholD, r)
        r = (r - _shift_down(C, s).transpose(-1, -2) @ _shift_down(Dinv_r, s)
             - C @ _shift_up(Dinv_r, s))
    u = smallla.cho_solve(chol_final, r)
    return u[..., 0] if vec else u


def _H_solve(f: KKTFactors, bx: Primal) -> Primal:
    return Primal(w=cuda_kkt.cho_solve_vec(f.chol_Hw, bx.w),
                  p=bx.p / f.d_p, q=bx.q / f.d_q, sig=bx.sig / f.h_sig)


def solve_kkt(d: StageSOCP, f: KKTFactors, W, bx: Primal, by: torch.Tensor,
              bz: ConeVec, cfg: IPMConfig) -> Tuple[Primal, torch.Tensor, ConeVec]:
    """One structured KKT solve. Returns (ux, uy, uz)."""
    spec = _spec_of(d)
    bxt = socp.primal_axpy(bx, socp.apply_GT(d, C.winv2_apply(spec, W, bz)), 1.0)
    ry = socp.apply_A(d, _H_solve(f, bxt)) - by
    t1 = _tri_solve(cfg, f.tri, ry)
    coef = lane_sum(d.g_sig * t1) / f.sm_denom
    uy = t1 - f.sm_t * lane(coef, t1)
    ux = _H_solve(f, socp.primal_axpy(bxt, socp.apply_AT(d, uy), -1.0))
    gux = socp.apply_G(d, ux)
    uz = C.winv2_apply(spec, W, {k: gux[k] - bz[k] for k in gux})
    return ux, uy, uz


def _P_apply(d: StageSOCP, x: Primal) -> Primal:
    """The objective's quadratic part P x (pins, diagonal Q, rank-one rows)."""
    Pw = x.w * ((1.0 - d.free_w) + d.Q_w)
    if d.Q_r1.shape[2]:
        Pw = Pw + (d.Q_r1.transpose(-1, -2) @ (d.Q_r1 @ x.w[..., None]))[..., 0]
    return Primal(w=Pw, p=torch.zeros_like(x.p),
                  q=torch.zeros_like(x.q),
                  sig=x.sig * (1.0 - d.free_sig + d.Q_sig))


def kkt_residual(d: StageSOCP, W, ux: Primal, uy, uz, bx: Primal, by, bz):
    """Residual of the UNregularized KKT system (for iterative refinement)."""
    spec = _spec_of(d)
    rx = socp.primal_axpy(
        socp.primal_axpy(bx, _P_apply(d, ux), -1.0),
        socp.primal_axpy(socp.apply_AT(d, uy), socp.apply_GT(d, uz), 1.0), -1.0)
    ry = by - socp.apply_A(d, ux)
    gux = socp.apply_G(d, ux)
    w2uz = C.w_apply(spec, W, C.w_apply(spec, W, uz, inverse=False),
                     inverse=False)
    rz = {k: bz[k] - gux[k] + w2uz[k] for k in gux}
    return rx, ry, rz


def solve_kkt_refined(d, f, W, bx, by, bz, cfg: IPMConfig, steps=None):
    ux, uy, uz = solve_kkt(d, f, W, bx, by, bz, cfg)
    for _ in range(cfg.refine_steps if steps is None else steps):
        rx, ry, rz = kkt_residual(d, W, ux, uy, uz, bx, by, bz)
        cx, cy, cz = solve_kkt(d, f, W, rx, ry, rz, cfg)
        ux = socp.primal_axpy(ux, cx, 1.0)
        uy = uy + cy
        uz = {k: uz[k] + cz[k] for k in uz}
    return ux, uy, uz


class IPMState(NamedTuple):
    x: Primal
    y: torch.Tensor
    s: ConeVec
    z: ConeVec
    converged: torch.Tensor    # (B,) bool — certified: gap/pres/dres below tols
    iters: torch.Tensor        # (B,) int32
    gap: torch.Tensor          # (B,)
    pres: torch.Tensor         # (B,)
    dres: torch.Tensor         # (B,)
    stalled: torch.Tensor      # (B,) bool — the update gate failed
    prim_infeas: torch.Tensor  # (B,) bool
    dual_infeas: torch.Tensor  # (B,) bool


def _shift_into_cone(spec, v: ConeVec, e: ConeVec) -> ConeVec:
    """v + (1 + alpha_violation) e, per lane, so the result is interior."""
    alphas = []
    for k, kind in spec.items():
        if v[k][0].numel() == 0:
            continue
        if kind == "lin":
            alphas.append(-C.lane_min(v[k]))
        else:
            a = torch.linalg.vector_norm(v[k][..., 1:], dim=-1) - v[k][..., 0]
            alphas.append(C.lane_max(a))
    alpha = torch.clamp(torch.stack(alphas, 0).amax(0), min=0.0)
    return C.tree_add(v, e, 1.0 + alpha)


def _push_interior(spec, v: ConeVec, margin: float) -> ConeVec:
    out = {}
    for k, kind in spec.items():
        if kind == "lin":
            out[k] = torch.clamp(v[k], min=margin)
        else:
            tail, head = v[k][..., 1:], v[k][..., :1]
            need = torch.linalg.vector_norm(tail, dim=-1, keepdim=True) + margin
            out[k] = torch.cat([torch.maximum(head, need), tail], dim=-1)
    return out


def _identity_W(spec, like: ConeVec):
    W = {}
    for k, kind in spec.items():
        if kind == "lin":
            W[k] = {"w": torch.ones_like(like[k])}
        else:
            wbar = torch.zeros_like(like[k])
            wbar[..., 0] = 1.0
            W[k] = {"eta": torch.ones_like(like[k][..., 0]), "wbar": wbar}
    return W


def _all_finite(tree) -> torch.Tensor:
    ok = None
    for leaf in tree_leaves(tree):
        f = torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
        ok = f if ok is None else ok & f
    return ok


def ipm_solve(d: StageSOCP, cfg: IPMConfig, init: IPMState | None = None,
              init_valid: torch.Tensor | None = None) -> IPMState:
    """Solve a batch of subproblems.

    ``init``: warm start (raw coordinates). ``init_valid``: optional (B,)
    bool; when given, the cold conelp init is also computed and lanes with
    ``init_valid == False`` start from it instead of ``init``.
    """
    if cfg.gondzio_correctors:
        raise NotImplementedError("Gondzio correctors are not ported "
                                  "(gondzio_correctors must be 0)")
    nx_pq = d.c_p.shape[-1]
    d_raw = d
    if cfg.equilibrate:
        d, eq_scales = equilibrate_mod.equilibrate(d, iters=cfg.ruiz_iters)
        if init is not None:
            init = equilibrate_mod.scale_state(eq_scales, init, nx_pq, True)

    spec = _spec_of(d)
    h = socp.cone_h(d)
    c = socp.objective(d)
    b = d.b
    e = C.identity(spec, h)
    deg = C.degree(spec, h)
    dtype, device = d.c_w.dtype, d.c_w.device
    Bn = d.c_w.shape[0]

    def pin_project(x: Primal) -> Primal:
        return Primal(w=x.w * d.free_w, p=x.p, q=x.q, sig=x.sig * d.free_sig)

    if init is None or init_valid is not None:
        # cold init (CVXOPT conelp-style, W = I)
        W0 = _identity_W(spec, h)
        f0 = factorize(d, W0, cfg)
        xc, _, _ = solve_kkt(d, f0, W0, socp.primal_zeros(d), b, h, cfg)
        gxc = socp.apply_G(d, xc)
        sc = _shift_into_cone(spec, {k: h[k] - gxc[k] for k in gxc}, e)
        mc = Primal(w=-c.w, p=-c.p, q=-c.q, sig=-c.sig)
        _, yc, z_cand = solve_kkt(d, f0, W0, mc, torch.zeros_like(b),
                                  C.tree_scale(e, 0.0), cfg)
        zc = _shift_into_cone(spec, z_cand, e)
        xc = pin_project(xc)

    if init is not None:
        margin = cfg.warm_margin
        xw = pin_project(init.x)
        yw = init.y
        gxw = socp.apply_G(d, xw)
        sw = _push_interior(spec, {k: h[k] - gxw[k] for k in gxw}, margin)
        zw = _push_interior(spec, init.z, margin)
        if init_valid is None:
            x0, y0, s0, z0 = xw, yw, sw, zw
        else:
            x0, y0, s0, z0 = tree_where(init_valid, (xw, yw, sw, zw),
                                        (xc, yc, sc, zc))
    else:
        x0, y0, s0, z0 = xc, yc, sc, zc

    ones = torch.ones((Bn,), dtype=dtype, device=device)
    tau_obj = eq_scales.tau if cfg.equilibrate else ones
    cnorm = torch.maximum(tau_obj, torch.sqrt(socp.primal_inner(c, c)))
    bnorm = torch.clamp(torch.sqrt(lane_sum(b * b)), min=1.0)
    hnorm = torch.clamp(torch.sqrt(C.inner(h, h)), min=1.0)

    # dtype-aware tolerance floors (see IPMConfig.tol_eps_mult)
    eps = torch.finfo(dtype).eps
    tol_gap = torch.clamp(cfg.tol_eps_mult * eps / tau_obj, min=cfg.tol_gap)
    tol_feas = max(cfg.tol_feas, cfg.tol_eps_mult * eps)
    tol_dres = torch.clamp(cfg.tol_eps_mult * eps / tau_obj, min=cfg.tol_feas)
    tol_infeas = max(cfg.tol_infeas, cfg.tol_eps_mult * eps)

    false = torch.zeros((Bn,), dtype=torch.bool, device=device)
    inf = torch.full((Bn,), float("inf"), dtype=dtype, device=device)
    state = IPMState(
        x=x0, y=y0, s=s0, z=z0, converged=false,
        iters=torch.zeros((Bn,), dtype=torch.int32, device=device),
        gap=inf, pres=inf, dres=inf, stalled=false,
        prim_infeas=false, dual_infeas=false,
    )

    def body(st: IPMState) -> IPMState:
        x, y, s, z = st.x, st.y, st.s, st.z
        Px = _P_apply(d, x)
        rx = socp.primal_axpy(
            socp.primal_axpy(socp.primal_axpy(c, Px, 1.0),
                             socp.apply_AT(d, y), 1.0),
            socp.apply_GT(d, z), 1.0)
        ry = socp.apply_A(d, x) - b
        gx = socp.apply_G(d, x)
        rz = {k: gx[k] + s[k] - h[k] for k in gx}

        sz = C.inner(s, z)
        mu = sz / deg
        cx = socp.primal_inner(c, x)
        gap = sz / torch.maximum(tau_obj, torch.abs(cx))
        pres = torch.sqrt(lane_sum(ry * ry) + C.inner(rz, rz)) / torch.maximum(
            bnorm, hnorm)
        dres = torch.sqrt(socp.primal_inner(rx, rx)) / cnorm
        converged = (gap < tol_gap) & (pres < tol_feas) & (dres < tol_dres)

        # infeasibility certificates (scale-invariant ratios)
        aygz = socp.primal_axpy(socp.primal_axpy(rx, c, -1.0), Px, -1.0)
        by_hz = lane_sum(b * y) + C.inner(h, z)
        pinf_num = torch.sqrt(socp.primal_inner(aygz, aygz))
        prim_infeas_now = (by_hz < 0.0) & (pinf_num < tol_infeas * (-by_hz))
        ax = ry + b
        gxs = {k: rz[k] + h[k] for k in rz}
        dinf_num = torch.sqrt(socp.primal_inner(Px, Px) + lane_sum(ax * ax)
                              + C.inner(gxs, gxs))
        dual_infeas_now = (cx < 0.0) & (dinf_num < tol_infeas * (-cx))

        active = ~(st.converged | converged | st.stalled | st.prim_infeas
                   | prim_infeas_now | st.dual_infeas | dual_infeas_now)

        W = C.nt_scaling(spec, s, z)
        lam = C.scaling_point(spec, W, z)
        f = factorize(d, W, cfg)

        # affine predictor (unrefined: it only sets centering + correction)
        ds_t = C.jordan_mul(spec, lam, lam)
        wj = C.w_apply(spec, W, C.jordan_solve(spec, lam, ds_t))
        bz_a = {k: -rz[k] + wj[k] for k in rz}
        nrx_ = Primal(w=-rx.w, p=-rx.p, q=-rx.q, sig=-rx.sig)
        dx_a, dy_a, dz_a = solve_kkt_refined(d, f, W, nrx_, -ry, bz_a, cfg,
                                             steps=0)
        gdx = socp.apply_G(d, dx_a)
        ds_a = {k: -rz[k] - gdx[k] for k in rz}
        step_s = C.max_step(spec, s, ds_a)
        step_z = C.max_step(spec, z, dz_a)
        alpha_aff = torch.clamp(torch.minimum(step_s, step_z), max=1.0)
        mu_aff = C.inner(C.tree_add(s, ds_a, alpha_aff),
                         C.tree_add(z, dz_a, alpha_aff)) / deg
        eta = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
        emu = eta * mu

        if cfg.corrector:
            wds = C.w_apply(spec, W, ds_a, inverse=True)
            wdz = C.w_apply(spec, W, dz_a, inverse=False)
            gamma = C.jordan_mul(spec, wds, wdz)
            ds_t2 = {k: ds_t[k] + gamma[k] - lane(emu, e[k]) * e[k]
                     for k in ds_t}
        else:
            ds_t2 = {k: ds_t[k] - lane(emu, e[k]) * e[k] for k in ds_t}

        wj2 = C.w_apply(spec, W, C.jordan_solve(spec, lam, ds_t2))
        bz_c = {k: -rz[k] + wj2[k] for k in rz}
        dx, dy, dz = solve_kkt_refined(d, f, W, nrx_, -ry, bz_c, cfg)
        gdx = socp.apply_G(d, dx)
        ds = {k: -rz[k] - gdx[k] for k in rz}
        step_s = C.max_step(spec, s, ds)
        step_z = C.max_step(spec, z, dz)
        alpha = torch.clamp(cfg.frac_to_boundary * torch.minimum(step_s, step_z),
                            max=1.0)

        # a converged or numerically exhausted lane never moves: where(),
        # not alpha * dx, so a NaN direction cannot leak in
        ok = (active & _all_finite((dx, dy, dz, ds)) & torch.isfinite(alpha)
              & (alpha > cfg.min_step))
        x_n = pin_project(socp.primal_axpy(x, dx, alpha))
        moved = (x_n, y + lane(alpha, dy) * dy, C.tree_add(s, ds, alpha),
                 C.tree_add(z, dz, alpha))
        x_n, y_n, s_n, z_n = tree_where(ok, moved, (x, y, s, z))
        return IPMState(
            x=x_n, y=y_n, s=s_n, z=z_n,
            converged=st.converged | converged,
            iters=st.iters + active.to(torch.int32),
            gap=torch.where(torch.isfinite(gap), gap, st.gap),
            pres=torch.where(torch.isfinite(pres), pres, st.pres),
            dres=torch.where(torch.isfinite(dres), dres, st.dres),
            stalled=st.stalled | (active & ~ok),
            prim_infeas=st.prim_infeas | (~st.converged & prim_infeas_now),
            dual_infeas=st.dual_infeas | (~st.converged & dual_infeas_now),
        )

    # per-lane while loop: a lane runs until a terminal flag or max_iters;
    # lanes that stopped are held by the select (the batched while_loop's
    # semantics), and the loop ends early when no lane runs
    for _ in range(cfg.max_iters):
        running = ~(state.converged | state.stalled | state.prim_infeas
                    | state.dual_infeas)
        if not bool(running.any()):
            break
        state = tree_where(running, body(state), state)

    if cfg.equilibrate:
        state = equilibrate_mod.scale_state(eq_scales, state, nx_pq, False)

    # infeasibility certificates at the FINAL iterate, in raw coordinates
    x, y, s, z = state.x, state.y, state.s, state.z
    dr = d_raw
    hr = socp.cone_h(dr)
    cr = socp.objective(dr)
    Px = _P_apply(dr, x)
    aygz = socp.primal_axpy(socp.apply_AT(dr, y), socp.apply_GT(dr, z), 1.0)
    by_hz = lane_sum(dr.b * y) + C.inner(hr, z)
    pinf_num = torch.sqrt(socp.primal_inner(aygz, aygz))
    prim_f = (by_hz < 0.0) & (pinf_num < tol_infeas * (-by_hz))
    ax = socp.apply_A(dr, x)
    gx = socp.apply_G(dr, x)
    gxs = {k: gx[k] + s[k] for k in gx}
    cx = socp.primal_inner(cr, x)
    dinf_num = torch.sqrt(socp.primal_inner(Px, Px) + lane_sum(ax * ax)
                          + C.inner(gxs, gxs))
    dual_f = (cx < 0.0) & (dinf_num < tol_infeas * (-cx))
    return state._replace(
        prim_infeas=state.prim_infeas | (~state.converged & prim_f),
        dual_infeas=state.dual_infeas | (~state.converged & dual_f),
    )
