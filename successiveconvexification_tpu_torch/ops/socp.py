"""Convex-subproblem assembly: model + discretization -> structured stage SOCP.

The PyTorch counterpart of the JAX package's ``ops/socp.py``: the same
stage-block form, with an explicit scenario axis 0 on every field.

Decision variables, all DELTAS about the reference trajectory:
  per node k:      w_k = (dx~_k [nrx], du_k [nu], t_k [1])  (t = feasibility buffer)
  per interval k:  p_k, q_k >= 0, the split virtual control nu_k = p_k - q_k
  global:          dsigma
Equalities: E_k w_k + F_k w_{k+1} + g_sig_k dsigma - p_k + q_k = b_k.
Cones: the model's stage rows and SOCs, the per-node trust-region SOC, the
p/q/t orthants and the dsigma rows.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from successiveconvexification_tpu_torch.config import ScvxConfig
from successiveconvexification_tpu_torch.models.base import Model
from successiveconvexification_tpu_torch.ops.cones import lane, lane_sum
from successiveconvexification_tpu_torch.ops.discretize import Discretization


class StageSOCP(NamedTuple):
    """All data of a batch of convex subproblems (axis 0 = scenario)."""

    c_w: torch.Tensor      # (B, K, nw)
    c_p: torch.Tensor      # (B, K-1, nrx)
    c_q: torch.Tensor      # (B, K-1, nrx)
    c_sig: torch.Tensor    # (B,)
    Q_w: torch.Tensor      # (B, K, nw) diagonal quadratic weights
    Q_sig: torch.Tensor    # (B,)
    Q_r1: torch.Tensor     # (B, K, n_dirs, nw) rank-one rows (model.penalized_dirs)
    G_lin: torch.Tensor    # (B, K, nl, nw)
    h_lin: torch.Tensor    # (B, K, nl)
    G_socs: Tuple[torch.Tensor, ...]  # each (B, K, d_i, nw); last = trust region
    h_socs: Tuple[torch.Tensor, ...]  # each (B, K, d_i)
    G_sig: torch.Tensor    # (B, 4)
    h_sig: torch.Tensor    # (B, 4)
    E: torch.Tensor        # (B, K-1, nrx, nw)
    F: torch.Tensor        # (B, K-1, nrx, nw)
    g_sig: torch.Tensor    # (B, K-1, nrx)
    b: torch.Tensor        # (B, K-1, nrx)
    eq_row_free: torch.Tensor  # (B, K-1, nrx)
    free_w: torch.Tensor   # (B, K, nw) 1 = free, 0 = pinned
    free_sig: torch.Tensor # (B,)
    Bx: torch.Tensor       # (B, K, nx, nrx) tangent basis


def cone_spec(model: Model) -> Dict[str, str]:
    """Static cone-group spec for this model's subproblems."""
    spec = {"lin": "lin", "pq": "lin", "sig": "lin"}
    for i in range(len(model.soc_dims)):
        spec[f"soc{i}"] = "soc"
    spec["tr"] = "soc"
    return spec


def dims(model: Model, K: int):
    nx, nu = model.nx, model.nu
    nw = nx + nu + 1
    return dict(nx=nx, nu=nu, nw=nw, K=K, nl=model.n_lin + 1, ntr=1 + nx + nu)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def assemble(model: Model, cfg: ScvxConfig, params, disc: Discretization,
             X: torch.Tensor, U: torch.Tensor, sigma: torch.Tensor,
             tr_radius: torch.Tensor, free_final_time: bool = True,
             penalty_scale=1.0) -> StageSOCP:
    """Assemble the batch of stage SOCPs. X (B, K, nx), sigma/tr_radius (B,)."""
    Bn, K, nx = X.shape
    nu = model.nu
    dtype, device = X.dtype, X.device
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    pk = params.unsqueeze(1)

    if model.state_basis is not None:
        nrx = model.nr
        Bx = model.state_basis(pk, X)
    else:
        nrx = nx
        Bx = torch.eye(nx, dtype=dtype, device=device).expand(Bn, K, nx, nx)

    nw = nrx + nu + 1
    it_col = nrx + nu

    def reduce_cols(G):
        return torch.cat([G[..., :nx] @ Bx, G[..., nx:]], dim=-1)

    G_lin_m, h_lin_m, socs_m = model.stage_cones(pk, X, U)
    G_lin_m = reduce_cols(G_lin_m)
    G_lin = torch.cat([G_lin_m, -torch.ones(G_lin_m.shape[:-1] + (1,),
                                            dtype=dtype, device=device)], -1)
    t_row_G = zeros(Bn, K, 1, nw)
    t_row_G[..., 0, it_col] = -1.0
    G_lin = torch.cat([G_lin, t_row_G], dim=2)
    h_lin = torch.cat([h_lin_m, zeros(Bn, K, 1)], dim=2)

    G_socs, h_socs = [], []
    for (G_s, h_s) in socs_m:
        G_s = reduce_cols(G_s)
        tcol = zeros(Bn, K, G_s.shape[2], 1)
        tcol[..., 0, 0] = -1.0
        G_socs.append(torch.cat([G_s, tcol], dim=-1))
        h_socs.append(h_s)

    # trust-region SOC: s = (Delta, dx~, du); no feasibility buffer
    ntr = 1 + nrx + nu
    if cfg.tr_mode == "soft":
        cone_radius = cfg.soft_tr_cap + 0.0 * tr_radius
    else:
        cone_radius = tr_radius
    G_tr = zeros(Bn, K, ntr, nw)
    G_tr[..., 1:, : nrx + nu] = -torch.eye(nrx + nu, dtype=dtype, device=device)
    h_tr = zeros(Bn, K, ntr)
    h_tr[..., 0] = cone_radius[:, None]
    G_socs.append(G_tr)
    h_socs.append(h_tr)

    # sigma rows (hard mode couples the time trust region to tr_radius)
    if cfg.tr_mode == "soft":
        tr_sig = cfg.tr_sigma_frac * sigma
    else:
        tr_sig = cfg.tr_sigma_frac * sigma * torch.clamp(tr_radius, max=1.0)
    sig_lo = sigma - cfg.sigma_min_frac * sigma
    sig_hi = cfg.sigma_max_frac * sigma - sigma
    G_sig = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dtype,
                         device=device).expand(Bn, 4)
    h_sig = torch.stack([tr_sig, tr_sig, sig_lo, sig_hi], dim=-1)

    # dynamics equalities in reduced rows and columns
    BT1 = Bx[:, 1:].transpose(-1, -2)                  # (B, K-1, nrx, nx)
    A_r = BT1 @ disc.A @ Bx[:, :-1]
    Bm_r = BT1 @ disc.Bm
    Bp_r = BT1 @ disc.Bp
    eye = torch.eye(nrx, dtype=dtype, device=device).expand(Bn, K - 1, nrx, nrx)
    zero_t = zeros(Bn, K - 1, nrx, 1)
    E = torch.cat([-A_r, -Bm_r, zero_t], dim=-1)
    F = torch.cat([eye, -Bp_r, zero_t], dim=-1)
    g_sig = -_mv(BT1, disc.S)
    # anchored at the NONLINEAR propagation (see the JAX package's assemble)
    b = _mv(BT1, disc.defect)

    # cost
    pscale = torch.as_tensor(penalty_scale, dtype=dtype, device=device)
    pscale = pscale.expand(Bn) if pscale.dim() == 0 else pscale
    c_w = zeros(Bn, K, nw)
    c_w[..., it_col] = cfg.w_feas * pscale[:, None]
    if model.mass_index is not None and cfg.w_mass:
        c_w[:, K - 1, model.mass_index] += -cfg.w_mass
    c_p = torch.full((Bn, K - 1, nrx), cfg.w_nu, dtype=dtype,
                     device=device) * pscale[:, None, None]
    c_q = c_p.clone()
    c_sig = torch.full((Bn,), cfg.w_sigma if free_final_time else 0.0,
                       dtype=dtype, device=device)

    Q_w = zeros(Bn, K, nw)
    Q_sig = zeros(Bn)
    if cfg.tr_mode == "soft":
        lam = pscale / tr_radius
        Q_w[..., : nrx + nu] = cfg.soft_tr_weight * lam[:, None, None]
        Q_sig = cfg.soft_tr_sigma_weight * lam
    # the model's penalized directions as rank-one rows, scaled so that H
    # gets w_dir_penalty v v'
    if model.penalized_dirs is not None:
        dirs = reduce_cols(model.penalized_dirs(pk, X, U))
        dirs = torch.cat([dirs, zeros(*dirs.shape[:-1], 1)], dim=-1)  # t column
        Q_r1 = math.sqrt(cfg.w_dir_penalty) * dirs
    else:
        Q_r1 = zeros(Bn, K, 0, nw)

    # pins (reduced coordinates)
    free_w = torch.ones((Bn, K, nw), dtype=dtype, device=device)
    if model.state_basis is not None:
        init_pin, term_pin = model.init_pinned_r, model.term_pinned_r
    else:
        init_pin, term_pin = model.init_pinned, model.term_pinned
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    free_w[:, 0, :nrx] = 1.0 - t(init_pin)
    free_w[:, K - 1, :nrx] = 1.0 - t(term_pin)
    free_w[:, K - 1, nrx: nrx + nu] = 1.0 - t(model.term_u_pinned)
    free_sig = torch.full((Bn,), 1.0 if free_final_time else 0.0, dtype=dtype,
                          device=device)

    G_lin = G_lin * free_w[:, :, None, :]
    G_socs = tuple(G * free_w[:, :, None, :] for G in G_socs)
    Q_r1 = Q_r1 * free_w[:, :, None, :]
    E = E * free_w[:, :-1, None, :]
    F = F * free_w[:, 1:, None, :]
    G_sig = G_sig * free_sig[:, None]
    g_sig = g_sig * free_sig[:, None, None]
    c_w = c_w * free_w
    c_sig = c_sig * free_sig
    eq_row_free = torch.ones((Bn, K - 1, nrx), dtype=dtype, device=device)

    return StageSOCP(
        c_w=c_w, c_p=c_p, c_q=c_q, c_sig=c_sig, Q_w=Q_w, Q_sig=Q_sig, Q_r1=Q_r1,
        G_lin=G_lin, h_lin=h_lin, G_socs=tuple(G_socs), h_socs=tuple(h_socs),
        G_sig=G_sig, h_sig=h_sig, E=E, F=F, g_sig=g_sig, b=b,
        eq_row_free=eq_row_free, free_w=free_w, free_sig=free_sig, Bx=Bx,
    )


# ----------------------------------------------------------- operator applies
class Primal(NamedTuple):
    w: torch.Tensor     # (B, K, nw)
    p: torch.Tensor     # (B, K-1, nrx)
    q: torch.Tensor     # (B, K-1, nrx)
    sig: torch.Tensor   # (B,)


def primal_zeros(d: StageSOCP) -> Primal:
    return Primal(w=torch.zeros_like(d.c_w), p=torch.zeros_like(d.c_p),
                  q=torch.zeros_like(d.c_q), sig=torch.zeros_like(d.c_sig))


def apply_G(d: StageSOCP, x: Primal) -> Dict[str, torch.Tensor]:
    out = {
        "lin": _mv(d.G_lin, x.w),
        "pq": torch.cat([-x.p, -x.q], dim=-1),
        "sig": d.G_sig * x.sig[:, None],
    }
    for i, G in enumerate(d.G_socs[:-1]):
        out[f"soc{i}"] = _mv(G, x.w)
    out["tr"] = _mv(d.G_socs[-1], x.w)
    return out


def apply_GT(d: StageSOCP, lam: Dict[str, torch.Tensor]) -> Primal:
    nx = d.c_p.shape[-1]
    w = _mtv(d.G_lin, lam["lin"])
    for i, G in enumerate(d.G_socs[:-1]):
        w = w + _mtv(G, lam[f"soc{i}"])
    w = w + _mtv(d.G_socs[-1], lam["tr"])
    return Primal(w=w, p=-lam["pq"][..., :nx], q=-lam["pq"][..., nx:],
                  sig=torch.sum(d.G_sig * lam["sig"], dim=-1))


def cone_h(d: StageSOCP) -> Dict[str, torch.Tensor]:
    out = {
        "lin": d.h_lin,
        "pq": torch.zeros_like(torch.cat([d.c_p, d.c_q], dim=-1)),
        "sig": d.h_sig,
    }
    for i, h in enumerate(d.h_socs[:-1]):
        out[f"soc{i}"] = h
    out["tr"] = d.h_socs[-1]
    return out


def apply_A(d: StageSOCP, x: Primal) -> torch.Tensor:
    """(B, K-1, nrow) equality LHS (virtual control on the nx dynamics rows)."""
    nx = d.c_p.shape[-1]
    out = (_mv(d.E, x.w[:, :-1]) + _mv(d.F, x.w[:, 1:])
           + d.g_sig * x.sig[:, None, None])
    return torch.cat([out[..., :nx] - x.p + x.q, out[..., nx:]], dim=-1)


def apply_AT(d: StageSOCP, y: torch.Tensor) -> Primal:
    nx = d.c_p.shape[-1]
    wE = _mtv(d.E, y)
    wF = _mtv(d.F, y)
    z1 = torch.zeros_like(wE[:, :1])
    w = torch.cat([wE, z1], dim=1) + torch.cat([z1, wF], dim=1)
    return Primal(w=w, p=-y[..., :nx], q=y[..., :nx], sig=lane_sum(d.g_sig * y))


def linear_merit_terms(d: StageSOCP, x: Primal):
    """Per-lane (nu_l1, viol_sum) of the LINEAR model at a candidate."""
    nx = d.c_p.shape[-1]
    x0 = Primal(w=x.w, p=torch.zeros_like(x.p), q=torch.zeros_like(x.q),
                sig=x.sig)
    nu_eval = (apply_A(d, x0) - d.b)[..., :nx]
    nu_l1 = lane_sum(torch.abs(nu_eval))
    wt0 = torch.cat([x.w[..., :-1], torch.zeros_like(x.w[..., -1:])], dim=-1)
    s_lin = d.h_lin - _mv(d.G_lin, wt0)
    viol = torch.amax(torch.clamp(-s_lin[..., :-1], min=0.0), dim=-1)
    for G, h in zip(d.G_socs[:-1], d.h_socs[:-1]):
        s = h - _mv(G, wt0)
        v = torch.clamp(torch.sqrt(torch.sum(s[..., 1:] ** 2, dim=-1) + 1e-16)
                        - s[..., 0], min=0.0)
        viol = torch.maximum(viol, v)
    return nu_l1, lane_sum(viol)


def objective(d: StageSOCP) -> Primal:
    return Primal(w=d.c_w, p=d.c_p, q=d.c_q, sig=d.c_sig)


def primal_inner(a: Primal, b: Primal) -> torch.Tensor:
    return (lane_sum(a.w * b.w) + lane_sum(a.p * b.p) + lane_sum(a.q * b.q)
            + a.sig * b.sig)


def primal_axpy(a: Primal, b: Primal, alpha) -> Primal:
    """a + alpha b, with alpha a scalar or a per-lane (B,) tensor."""
    return Primal(w=a.w + lane(alpha, a.w) * b.w,
                  p=a.p + lane(alpha, a.p) * b.p,
                  q=a.q + lane(alpha, a.q) * b.q,
                  sig=a.sig + lane(alpha, a.sig) * b.sig)
