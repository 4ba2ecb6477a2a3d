"""SCvx outer loop: successive convexification with a hard trust region (PyTorch).

The counterpart of the JAX package's ``ops/scvx.py``. ``scvx_iteration`` is
one batched function over a fixed-shape carry: discretize -> assemble ->
IPM -> propagate, merit and accept/reject, with every accept/reject decision
a per-lane ``torch.where``. Axis 0 of every carry tensor is the scenario.

Acceptance: rho = (J_nl(current) - J_nl(candidate)) /
(J_nl(current) - J_lin(candidate)), with the filter track (accept on a
strict drop of the raw infeasibility) and the penalty continuation of the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from successiveconvexification_tpu_torch.config import SolverConfig
from successiveconvexification_tpu_torch.models.base import Model
from successiveconvexification_tpu_torch.ops import cones as C
from successiveconvexification_tpu_torch.ops import ipm, socp
from successiveconvexification_tpu_torch.ops.cones import lane, lane_max, lane_sum
from successiveconvexification_tpu_torch.ops.discretize import (
    condense,
    discretize,
    propagate,
)
from successiveconvexification_tpu_torch.ops.precision import resolve_device
from successiveconvexification_tpu_torch.utils.tree import tree_map, tree_where


class ScvxState(NamedTuple):
    """Fixed-shape SCvx carry; axis 0 = scenario lane."""

    X: torch.Tensor          # (B, K, nx)
    U: torch.Tensor          # (B, K, nu)
    sigma: torch.Tensor      # (B,)
    tr_radius: torch.Tensor  # (B,)
    penalty_scale: torch.Tensor  # (B,)
    obj_nl: torch.Tensor     # (B,)
    defect_nl: torch.Tensor  # (B,)
    viol_nl: torch.Tensor    # (B,)
    converged: torch.Tensor  # (B,) bool
    iterations: torch.Tensor # (B,) int32
    n_accept: torch.Tensor   # (B,) int32
    n_reject: torch.Tensor   # (B,) int32
    n_bump: torch.Tensor     # (B,) int32
    accepted: torch.Tensor   # (B,) bool
    rho: torch.Tensor        # (B,)
    nu_norm: torch.Tensor    # (B,)
    dx_max: torch.Tensor     # (B,)
    pred_dec: torch.Tensor   # (B,)
    ipm_gap: torch.Tensor    # (B,)
    ipm_iters: torch.Tensor  # (B,) int32
    ipm_carry: object        # ipm.IPMState — warm start for the next subproblem

    @property
    def J_nl(self):
        return self.obj_nl + self.defect_nl + self.viol_nl


def cone_violation(model: Model, params, X, U):
    """Per-lane sum over nodes of the max stage-cone violation at (X, U)."""
    _, h_lin, socs = model.stage_cones(params.unsqueeze(1), X, U)
    v = torch.amax(torch.clamp(-h_lin, min=0.0), dim=-1)
    for (_, h_s) in socs:
        v = torch.maximum(v, torch.clamp(
            torch.sqrt(torch.sum(h_s[..., 1:] ** 2, dim=-1) + 1e-16) - h_s[..., 0],
            min=0.0))
    return lane_sum(v)


def merit_components(model: Model, cfg: SolverConfig, params, X, U, sigma):
    """Per-lane (obj, defect_l1, viol_sum) of the nonlinear penalty merit."""
    s = cfg.scvx
    x_prop = propagate(model, params, X, U, sigma, substeps=cfg.disc.substeps,
                       foh=cfg.disc.foh)
    raw = x_prop - X[:, 1:]
    if model.state_basis is not None:
        B1 = model.state_basis(params.unsqueeze(1), X[:, 1:])
        raw = (B1.transpose(-1, -2) @ raw[..., None])[..., 0]
    defect = lane_sum(torch.abs(raw))
    obj = s.w_sigma * sigma
    if model.mass_index is not None and s.w_mass:
        obj = obj - s.w_mass * X[:, -1, model.mass_index]
    viol = cone_violation(model, params, X, U)
    return obj, defect, viol


def nonlinear_cost(model: Model, cfg: SolverConfig, params, X, U, sigma,
                   penalty_scale=1.0):
    s = cfg.scvx
    obj, defect, viol = merit_components(model, cfg, params, X, U, sigma)
    return obj + penalty_scale * (s.w_nu * defect + s.w_feas * viol)


def _unit_ipm_carry(model: Model, cfg: SolverConfig, params, X, U, sigma):
    """Interior unit point shaped like this problem's IPM state; gap = inf
    marks it invalid, so the first solve starts from the cold init."""
    del params, U, sigma
    Bn, K, nx = X.shape
    dtype, device = X.dtype, X.device
    nrx = model.nr if model.state_basis is not None else nx
    nw = nrx + model.nu + 1
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    shapes = {"lin": (Bn, K, model.n_lin + 1), "pq": (Bn, K - 1, 2 * nrx),
              "sig": (Bn, 4)}
    spec = {"lin": "lin", "pq": "lin", "sig": "lin"}
    for i, dim in enumerate(model.soc_dims):
        shapes[f"soc{i}"] = (Bn, K, dim)
        spec[f"soc{i}"] = "soc"
    shapes["tr"] = (Bn, K, 1 + nrx + model.nu)
    spec["tr"] = "soc"
    e = C.identity(spec, {k: z(*v) for k, v in shapes.items()})
    false = torch.zeros((Bn,), dtype=torch.bool, device=device)
    return ipm.IPMState(
        x=socp.Primal(w=z(Bn, K, nw), p=z(Bn, K - 1, nrx), q=z(Bn, K - 1, nrx),
                      sig=z(Bn)),
        y=z(Bn, K - 1, nrx), s=e, z=dict(e), converged=false,
        iters=torch.zeros((Bn,), dtype=torch.int32, device=device),
        gap=z(Bn) + float("inf"), pres=z(Bn), dres=z(Bn), stalled=false,
        prim_infeas=false, dual_infeas=false,
    )


def scvx_init(model: Model, params, cfg: SolverConfig) -> ScvxState:
    """Straight-line initial trajectories for a batch of params (B,)."""
    X, U, sigma = model.initial_guess(params, cfg.disc.K)
    obj, defect, viol = merit_components(model, cfg, params, X, U, sigma)
    tr = torch.full_like(sigma, cfg.scvx.tr_init)
    return _fresh_state(model, cfg, params, X, U, sigma.clone(), tr, obj,
                        defect, viol)


def _fresh_state(model, cfg, params, X, U, sigma, tr, obj, defect, viol):
    """A state with no iterations behind it and an invalid IPM carry."""
    Bn = X.shape[0]
    dtype, device = X.dtype, X.device
    z = torch.zeros((Bn,), dtype=dtype, device=device)
    zi = torch.zeros((Bn,), dtype=torch.int32, device=device)
    false = torch.zeros((Bn,), dtype=torch.bool, device=device)
    inf = z + float("inf")
    return ScvxState(
        X=X, U=U, sigma=sigma, tr_radius=tr,
        penalty_scale=z + 1.0, obj_nl=obj, defect_nl=defect, viol_nl=viol,
        converged=false, iterations=zi, n_accept=zi, n_reject=zi, n_bump=zi,
        accepted=false, rho=z, nu_norm=inf, dx_max=inf, pred_dec=inf,
        ipm_gap=z, ipm_iters=zi,
        ipm_carry=_unit_ipm_carry(model, cfg, params, X, U, sigma),
    )


def apply_boundary_conditions(model: Model, params, X: torch.Tensor) -> torch.Tensor:
    """Overwrite the pinned components of the first/last node with the BCs."""
    Xg, _, _ = model.initial_guess(params, X.shape[-2])
    init_pin = torch.tensor(model.init_pinned, dtype=X.dtype, device=X.device)
    term_pin = torch.tensor(model.term_pinned, dtype=X.dtype, device=X.device)
    first = init_pin * Xg[..., 0, :] + (1.0 - init_pin) * X[..., 0, :]
    last = term_pin * Xg[..., -1, :] + (1.0 - term_pin) * X[..., -1, :]
    return torch.cat([first[..., None, :], X[..., 1:-1, :], last[..., None, :]],
                     dim=-2)


def scvx_warm_start(model: Model, params, cfg: SolverConfig, X, U, sigma,
                    tr_radius=None, stm_correct: bool = True) -> ScvxState:
    """Build a batched ScvxState from a previous solution (replanning).

    ``params`` has a batch axis (B,); the previous solution is per lane
    (X (B, K, nx), U (B, K, nu), sigma (B,)) or one nominal (X (K, nx),
    U (K, nu), sigma a scalar) shared by every lane. The state lands on
    X's device in the config's dtype.

    The pinned boundary components are overwritten with the NEW params'
    boundary conditions. ``stm_correct`` propagates the node-0 shift through
    the previous solution's linearized dynamics, delta_k = Phi_{0->k}
    delta_0 (``discretize.condense``), tapered to zero toward the pinned
    terminal node, so the initial-condition mismatch is spread over the
    horizon instead of concentrated in one interval's defect.

    ``tr_radius``: initial trust radius (scalar or (B,)). Default: each
    lane's nonlinear defect plus violation, clipped to [8 tr_min, tr_init].
    """
    dtype = getattr(torch, cfg.dtype)
    params = to_device(params, cfg, X.device)
    Bn, K = params.batch_shape[0], X.shape[-2]
    X = X.to(dtype).expand(Bn, K, X.shape[-1]).contiguous()
    U = U.to(dtype).expand(Bn, K, U.shape[-1]).contiguous()
    sigma = torch.as_tensor(sigma, dtype=dtype, device=X.device).expand(Bn).clone()
    X_prev = X
    X = apply_boundary_conditions(model, params, X)
    if stm_correct:
        delta0 = X[:, 0] - X_prev[:, 0]
        disc0 = discretize(model, params, X_prev, U, sigma,
                           substeps=cfg.disc.substeps, foh=cfg.disc.foh)
        Phi = condense(disc0)                               # (B, K-1, nx, nx)
        # taper 1 -> 0 so the pinned terminal node stays put
        w = 1.0 - torch.arange(1, K, dtype=dtype, device=X.device) / (K - 1)
        shift = w[:, None] * (Phi @ delta0[:, None, :, None])[..., 0]
        X = X + torch.cat([torch.zeros_like(X[:, :1]), shift], dim=1)
        X = apply_boundary_conditions(model, params, X)
    if model.project_state is not None:
        X = model.project_state(X)
    obj, defect, viol = merit_components(model, cfg, params, X, U, sigma)
    if tr_radius is None:
        tr = torch.clamp(defect + viol, 8.0 * cfg.scvx.tr_min, cfg.scvx.tr_init)
    else:
        tr = torch.as_tensor(tr_radius, dtype=dtype,
                             device=X.device).expand(Bn).clone()
    return _fresh_state(model, cfg, params, X, U, sigma, tr, obj, defect, viol)


def scvx_iteration(model: Model, params, cfg: SolverConfig, st: ScvxState,
                   assume_warm_valid: bool = False) -> ScvxState:
    """One batched SCvx iteration (discretize + assemble + IPM + accept).

    ``assume_warm_valid``: the caller certifies every lane's carry is valid
    (gap finite), so the cold init is skipped and, with
    ``equilibrate_cold_only``, so is the Ruiz presolve."""
    s = cfg.scvx
    dtype = st.X.dtype
    active = ~st.converged
    scale = st.penalty_scale

    disc = discretize(model, params, st.X, st.U, st.sigma,
                      substeps=cfg.disc.substeps, foh=cfg.disc.foh)
    d = socp.assemble(model, s, params, disc, st.X, st.U, st.sigma,
                      st.tr_radius, free_final_time=cfg.free_final_time,
                      penalty_scale=scale)

    if cfg.ipm.warm_start and assume_warm_valid:
        ipm_cfg = cfg.ipm
        if cfg.ipm.equilibrate and cfg.ipm.equilibrate_cold_only:
            ipm_cfg = dataclasses.replace(cfg.ipm, equilibrate=False)
        sol = ipm.ipm_solve(d, ipm_cfg, init=st.ipm_carry)
    elif cfg.ipm.warm_start:
        sol = ipm.ipm_solve(d, cfg.ipm, init=st.ipm_carry,
                            init_valid=torch.isfinite(st.ipm_carry.gap))
    else:
        sol = ipm.ipm_solve(d, cfg.ipm)

    nu = model.nu
    nrx = model.nr if model.state_basis is not None else model.nx
    dXr = sol.x.w[..., :nrx]
    dX = (d.Bx @ dXr[..., None])[..., 0]
    dU = sol.x.w[..., nrx: nrx + nu]
    X_new = st.X + dX
    if model.project_state is not None:
        X_new = model.project_state(X_new)
    U_new = st.U + dU
    sigma_new = st.sigma + sol.x.sig
    nu_l1, t_sum = socp.linear_merit_terms(d, sol.x)
    dx_max = torch.maximum(
        torch.maximum(lane_max(torch.abs(dXr)), lane_max(torch.abs(dU))),
        torch.abs(sol.x.sig) / st.sigma)

    J_cur = st.obj_nl + scale * (s.w_nu * st.defect_nl + s.w_feas * st.viol_nl)
    obj2, def2, viol2 = merit_components(model, cfg, params, X_new, U_new,
                                         sigma_new)
    J_new = obj2 + scale * (s.w_nu * def2 + s.w_feas * viol2)
    obj_lin = s.w_sigma * sigma_new
    if model.mass_index is not None and s.w_mass:
        obj_lin = obj_lin - s.w_mass * X_new[:, -1, model.mass_index]
    J_lin = obj_lin + scale * (s.w_nu * nu_l1 + s.w_feas * t_sum)
    if s.tr_mode == "soft":
        # the damping (and the penalized directions) the step pays is part of
        # the cost the subproblem minimized, so of the predicted cost
        q_cost = 0.5 * (lane_sum(d.Q_w * sol.x.w ** 2)
                        + d.Q_sig * sol.x.sig ** 2)
        if d.Q_r1.shape[2]:
            q_cost = q_cost + 0.5 * lane_sum((d.Q_r1 @ sol.x.w[..., None]) ** 2)
        J_lin = J_lin + q_cost

    predicted = J_cur - J_lin
    actual = J_cur - J_new
    rho = actual / torch.clamp(predicted, min=1e-10)

    big = torch.clamp(torch.abs(J_cur), min=1.0)
    ipm_ok = torch.isfinite(dX).reshape(dX.shape[0], -1).all(1) & torch.isfinite(J_new)
    solve_ok = (ipm_ok & torch.isfinite(sol.gap)
                & (sol.pres < s.solve_fail_res) & (sol.dres < s.solve_fail_res)
                & (predicted > -s.conv_tol_pred * big))
    h_cur = st.defect_nl + st.viol_nl
    h_new = def2 + viol2
    feas_step = h_new <= s.filter_gamma * h_cur
    accept = ((rho >= s.rho0) | feas_step) & ipm_ok

    tr_shrunk = st.tr_radius * s.tr_shrink
    tr_grown = st.tr_radius * s.tr_grow
    tr_mid = st.tr_radius * (s.tr_grow_mid if s.tr_mode == "soft" else s.tr_hold)
    tr_next = torch.where(~accept | (rho < s.rho1), tr_shrunk,
                          torch.where(rho < s.rho2, tr_mid, tr_grown))
    tr_next = torch.clamp(tr_next, s.tr_min, s.tr_max)

    upd = active & accept

    def pick(new, old):
        return tree_where(upd, new, old)

    defect_after = pick(def2, st.defect_nl)
    viol_after = pick(viol2, st.viol_nl)

    small_step = solve_ok & (dx_max < s.conv_tol_tr)
    small_pred = solve_ok & (predicted < s.conv_tol_pred * big)
    stationary = small_step | small_pred
    tol_feas = max(s.conv_tol_feas,
                   s.conv_feas_eps_mult * torch.finfo(dtype).eps * st.X[0].numel())
    feasible = (defect_after + viol_after) < tol_feas
    stalled = stationary | (tr_next <= 8.0 * s.tr_min)
    bump = active & stalled & (~feasible) & (st.penalty_scale < s.penalty_scale_max)
    conv_now = stationary & feasible

    tr_out = torch.where(active, tr_next, st.tr_radius)
    tr_bumped = torch.clamp(tr_next * s.tr_bump_grow, s.tr_min, s.tr_init)
    tr_out = torch.where(bump, tr_bumped, tr_out)
    pscale = torch.where(bump, st.penalty_scale * s.penalty_grow, st.penalty_scale)

    ipm_bad = (~solve_ok) | (sol.gap > s.carry_reset_gap)
    reset_carry = bump | (active & ipm_bad)

    # warm-start carry: duals reused; the primal delta re-centred (0 after an
    # accept, scaled into the shrunk radius after a reject)
    carry_x_scale = torch.where(upd, torch.zeros_like(st.sigma),
                                torch.full_like(st.sigma, s.tr_shrink))
    carry_sol = sol._replace(
        x=tree_map(lambda a: a * lane(carry_x_scale, a), sol.x))
    carry = tree_where(active, carry_sol, st.ipm_carry)
    inf = torch.full_like(sol.gap, float("inf"))
    carry = carry._replace(gap=torch.where(
        reset_carry, inf, torch.where(active, sol.gap, st.ipm_carry.gap)))

    one = lambda m: m.to(torch.int32)  # noqa: E731
    return ScvxState(
        X=pick(X_new, st.X),
        U=pick(U_new, st.U),
        sigma=pick(sigma_new, st.sigma),
        tr_radius=tr_out,
        penalty_scale=pscale,
        obj_nl=pick(obj2, st.obj_nl),
        defect_nl=defect_after,
        viol_nl=viol_after,
        converged=st.converged | (active & conv_now),
        iterations=st.iterations + one(active),
        n_accept=st.n_accept + one(active & accept),
        n_reject=st.n_reject + one(active & ~accept),
        n_bump=st.n_bump + one(bump),
        accepted=torch.where(active, accept, st.accepted),
        rho=torch.where(active, rho, st.rho),
        nu_norm=torch.where(active, nu_l1, st.nu_norm),
        dx_max=torch.where(active, dx_max, st.dx_max),
        pred_dec=torch.where(active, predicted, st.pred_dec),
        ipm_gap=torch.where(active, sol.gap, st.ipm_gap),
        ipm_iters=torch.where(active, sol.iters, st.ipm_iters),
        ipm_carry=carry,
    )


def scvx_solve(model: Model, params, cfg: SolverConfig,
               device=None) -> ScvxState:
    """Single-scenario solve: the batched solve of one lane (batch axis kept).

    ``params`` unbatched; ``device=None`` means the card."""
    from successiveconvexification_tpu_torch.parallel.batch import solve_batch

    pb = params.map(lambda v, tail: v[None])
    return solve_batch(model, pb, cfg, device=device)


def to_device(params, cfg: SolverConfig, device=None):
    """Params on the entry point's device in the config's dtype."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    return params.map(lambda v, tail: v.to(device=dev, dtype=dtype))
