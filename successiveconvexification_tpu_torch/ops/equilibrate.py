"""Structured Ruiz equilibration of the stage SOCP (PyTorch port).

The counterpart of the JAX package's ``ops/equilibrate.py``: a few fixed
passes of row/column infinity-norm balancing over the implicit constraint
matrix [A; G], one scalar per SOC (anything else would break cone
membership), p/q columns scaled analytically by ``dp = 1/ry[:, :nx]``, and a
final objective scale ``tau``. Every scale is per scenario lane (axis 0).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from successiveconvexification_tpu_torch.ops.cones import lane, lane_max
from successiveconvexification_tpu_torch.ops.socp import Primal, StageSOCP


class EqScales(NamedTuple):
    dw: torch.Tensor               # (B, K, nw)
    dsig: torch.Tensor             # (B,)
    ry: torch.Tensor               # (B, K-1, nrx)
    rlin: torch.Tensor             # (B, K, nl)
    rsocs: Tuple[torch.Tensor, ...]  # each (B, K); last = trust region
    rsig: torch.Tensor             # (B, 4)
    tau: torch.Tensor              # (B,)


def _inv(x):
    return torch.where(x > 0.0, 1.0 / torch.clamp(x, min=1e-30),
                       torch.ones_like(x))


def _rs(norm):
    return torch.where(norm > 0.0, torch.rsqrt(torch.clamp(norm, min=1e-30)),
                       torch.ones_like(norm))


def equilibrate(d: StageSOCP, iters: int = 3) -> Tuple[StageSOCP, EqScales]:
    """Ruiz-equilibrate a batch of StageSOCPs. Returns (scaled, scales)."""
    Bn, K, nw = d.c_w.shape
    nx = d.c_p.shape[-1]
    dtype, device = d.c_w.dtype, d.c_w.device

    aG_lin = torch.abs(d.G_lin)
    aG_socs = tuple(torch.abs(G) for G in d.G_socs)
    aG_sig = torch.abs(d.G_sig)
    aE = torch.abs(d.E)
    aF = torch.abs(d.F)
    ag_sig = torch.abs(d.g_sig)

    dw = torch.ones((Bn, K, nw), dtype=dtype, device=device)
    dsig = torch.ones((Bn,), dtype=dtype, device=device)
    ry = torch.ones_like(d.b)
    rlin = torch.ones_like(d.h_lin)
    rsocs = tuple(torch.ones((Bn, K), dtype=dtype, device=device)
                  for _ in d.G_socs)
    rsig = torch.ones((Bn, 4), dtype=dtype, device=device)
    pad = torch.zeros((Bn, 1, nw), dtype=dtype, device=device)

    for _ in range(iters):
        n_lin = rlin * torch.amax(aG_lin * dw[:, :, None, :], dim=-1)
        rlin = rlin * _rs(n_lin)

        rsocs = tuple(
            rs * _rs(rs * torch.amax(aG * dw[:, :, None, :], dim=(-2, -1)))
            for aG, rs in zip(aG_socs, rsocs))

        n_sig = rsig * aG_sig * dsig[:, None]
        rsig = rsig * _rs(n_sig)

        n_eq = torch.maximum(
            torch.amax(aE * dw[:, :-1, None, :], dim=-1),
            torch.amax(aF * dw[:, 1:, None, :], dim=-1),
        )
        n_eq = torch.maximum(n_eq, ag_sig * dsig[:, None, None])
        n_eq = ry * n_eq
        # the p/q entries on the dynamics rows stay exactly 1 (dp = 1/ry)
        n_eq = torch.cat([torch.clamp(n_eq[..., :nx], min=1.0), n_eq[..., nx:]],
                         dim=-1)
        ry = ry * _rs(n_eq)

        cw = torch.amax(aG_lin * rlin[..., None], dim=-2)
        for aG, rs in zip(aG_socs, rsocs):
            cw = torch.maximum(cw, rs[..., None] * torch.amax(aG, dim=-2))
        ce = torch.amax(aE * ry[..., None], dim=-2)
        cf = torch.amax(aF * ry[..., None], dim=-2)
        cw = torch.maximum(cw, torch.cat([ce, pad], 1))
        cw = torch.maximum(cw, torch.cat([pad, cf], 1))
        cw = dw * cw
        dw = dw * _rs(cw)

        c_sig_col = dsig * torch.maximum(lane_max(rsig * aG_sig),
                                         lane_max(ry * ag_sig))
        dsig = dsig * _rs(c_sig_col)

    dp = _inv(ry[..., :nx])
    cmax = torch.maximum(lane_max(torch.abs(d.c_w) * dw),
                         torch.abs(d.c_sig) * dsig)
    cmax = torch.maximum(cmax, lane_max(torch.abs(d.c_p) * dp))
    cmax = torch.maximum(cmax, lane_max(torch.abs(d.c_q) * dp))
    tau = _inv(torch.clamp(cmax, min=1.0))

    t3 = tau[:, None, None]
    d_eq = d._replace(
        c_w=t3 * dw * d.c_w,
        c_p=t3 * dp * d.c_p,
        c_q=t3 * dp * d.c_q,
        c_sig=tau * dsig * d.c_sig,
        Q_w=t3 * dw * dw * d.Q_w,
        Q_sig=tau * dsig * dsig * d.Q_sig,
        Q_r1=torch.sqrt(tau)[:, None, None, None] * d.Q_r1 * dw[:, :, None, :],
        G_lin=rlin[..., None] * d.G_lin * dw[:, :, None, :],
        h_lin=rlin * d.h_lin,
        G_socs=tuple(rs[..., None, None] * G * dw[:, :, None, :]
                     for rs, G in zip(rsocs, d.G_socs)),
        h_socs=tuple(rs[..., None] * h for rs, h in zip(rsocs, d.h_socs)),
        G_sig=rsig * d.G_sig * dsig[:, None],
        h_sig=rsig * d.h_sig,
        E=ry[..., None] * d.E * dw[:, :-1, None, :],
        F=ry[..., None] * d.F * dw[:, 1:, None, :],
        g_sig=ry * d.g_sig * dsig[:, None, None],
        b=ry * d.b,
    )
    return d_eq, EqScales(dw=dw, dsig=dsig, ry=ry, rlin=rlin, rsocs=rsocs,
                          rsig=rsig, tau=tau)


def _row_scales(eq: EqScales, nx: int) -> Dict[str, torch.Tensor]:
    rpq = eq.ry[..., :nx]
    out = {"lin": eq.rlin, "pq": torch.cat([rpq, rpq], dim=-1), "sig": eq.rsig}
    for i, rs in enumerate(eq.rsocs[:-1]):
        out[f"soc{i}"] = rs[..., None]
    out["tr"] = eq.rsocs[-1][..., None]
    return out


def scale_primal(eq: EqScales, x: Primal, to_scaled: bool) -> Primal:
    """x_scaled = D^-1 x (to_scaled) or x = D x_scaled."""
    nx = x.p.shape[-1]
    dp = _inv(eq.ry[..., :nx])
    if to_scaled:
        return Primal(w=x.w / eq.dw, p=x.p / dp, q=x.q / dp, sig=x.sig / eq.dsig)
    return Primal(w=x.w * eq.dw, p=x.p * dp, q=x.q * dp, sig=x.sig * eq.dsig)


def scale_state(eq: EqScales, st, nx: int, to_scaled: bool):
    """Map an IPMState between raw and equilibrated coordinates."""
    rg = _row_scales(eq, nx)
    tau = eq.tau
    if to_scaled:
        return st._replace(
            x=scale_primal(eq, st.x, True),
            y=lane(tau, st.y) * st.y / eq.ry,
            z={k: lane(tau, st.z[k]) * st.z[k] / rg[k] for k in st.z},
            s={k: rg[k] * st.s[k] for k in st.s},
        )
    return st._replace(
        x=scale_primal(eq, st.x, False),
        y=eq.ry * st.y / lane(tau, st.y),
        z={k: rg[k] * st.z[k] / lane(tau, st.z[k]) for k in st.z},
        s={k: st.s[k] / rg[k] for k in st.s},
    )
