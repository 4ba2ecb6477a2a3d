"""3-DoF point-mass powered-descent model, PyTorch port (BASELINE config 1).

State (nx=7):   x = (m, r_I[3], v_I[3]), inertial up = e1.
Control (nu=3): u = T_I, thrust in the inertial frame (no attitude).

    mdot = -alpha_m ||T||,  rdot = v,  vdot = T / m + g

Per-node cones (deltas about (xbar, ubar)): mass lower bound and linearized
thrust lower bound (linear), glideslope SOC(3), thrust upper bound SOC(4) —
the same rows as the JAX package's model: the classic lossless
convexification problem shape, the smallest end-to-end slice of the engine.

Every function is batched over leading dimensions, with params of batch
shape ``P`` as in ``models/rocket6dof.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from successiveconvexification_tpu_torch.models.base import (
    CudaDynamics,
    Model,
    Params,
    safe_norm,
)

NX = 7
NU = 3

I_M = 0
I_R = slice(1, 4)
I_V = slice(4, 7)

# trailing (non-batch) shape of every params field
_FIELD_TAIL = {
    "m_wet": (), "m_dry": (), "alpha_m": (), "T_min": (), "T_max": (),
    "tan_gamma_gs": (), "g_i": (3,), "r_init": (3,), "v_init": (3,),
    "r_final": (3,), "v_final": (3,), "tf_guess": (),
}


@dataclasses.dataclass(frozen=True)
class PointMass3DoFParams(Params):
    """Physical parameters: tensors with a common leading batch shape."""

    TAIL = _FIELD_TAIL

    m_wet: torch.Tensor
    m_dry: torch.Tensor
    alpha_m: torch.Tensor
    T_min: torch.Tensor
    T_max: torch.Tensor
    tan_gamma_gs: torch.Tensor
    g_i: torch.Tensor
    r_init: torch.Tensor
    v_init: torch.Tensor
    r_final: torch.Tensor
    v_final: torch.Tensor
    tf_guess: torch.Tensor


def default_params(dtype=torch.float32, device="cpu") -> PointMass3DoFParams:
    """Nondimensional landing scenario of the JAX package (unbatched)."""

    def f(*v):
        return torch.tensor(v if len(v) > 1 else v[0], dtype=dtype, device=device)

    return PointMass3DoFParams(
        m_wet=f(2.0),
        m_dry=f(1.0),
        alpha_m=f(0.05),
        T_min=f(0.5),
        T_max=f(6.0),
        tan_gamma_gs=f(math.tan(math.radians(25.0))),
        g_i=f(-1.0, 0.0, 0.0),
        r_init=f(6.0, 6.0, 2.0),
        v_init=f(-0.5, -2.0, -0.5),
        r_final=f(0.0, 0.0, 0.0),
        v_final=f(-0.1, 0.0, 0.0),
        tf_guess=f(6.0),
    )


def params_from_numpy(d: Mapping, device="cpu",
                      dtype=torch.float64) -> PointMass3DoFParams:
    """Build port params from a mapping of field name -> numpy array (the
    JAX package's params carry across this way; ``Params.from_numpy``)."""
    return PointMass3DoFParams.from_numpy(d, device=device, dtype=dtype)


def dynamics(params: PointMass3DoFParams, x: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    m = x[..., I_M]
    v = x[..., I_V]
    mdot = -params.alpha_m * safe_norm(u)
    vdot = u / m[..., None] + params.g_i
    parts = [mdot[..., None], v, vdot]
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], dim=-1)


# the fields csrc/disc.cu's pointmass3dof dynamics read, in its order
KERNEL_FIELDS = ("alpha_m", "g_i")


def kernel_params(params: PointMass3DoFParams) -> torch.Tensor:
    """(P..., 4): alpha_m, g_i of every scenario in one contiguous array;
    fields of batch shape () or broadcast are expanded to the common batch
    shape."""
    parts = [(getattr(params, k), _FIELD_TAIL[k]) for k in KERNEL_FIELDS]
    lead = torch.broadcast_shapes(*(v.shape[:v.dim() - len(t)]
                                    for v, t in parts))
    return torch.cat([v.expand(lead + t).reshape(lead + (-1,))
                      for v, t in parts], dim=-1)


# --------------------------------------------------------------------------- cones
N_LIN = 2                      # mass lower bound, linearized thrust lower bound
SOC_DIMS = (3, 4)              # glideslope, thrust-ub


def stage_cones(params: PointMass3DoFParams, xk: torch.Tensor,
                uk: torch.Tensor):
    """(G_lin, h_lin, socs) per node, in deltas about (xk, uk).

    Linear rows mean G @ (dx,du) <= h; SOC blocks mean h - G @ (dx,du) in SOC.
    """
    dtype, device = xk.dtype, xk.device
    nxu = NX + NU
    lead = torch.broadcast_shapes(xk.shape[:-1], uk.shape[:-1],
                                  params.batch_shape)
    xk = xk.expand(lead + (NX,))
    uk = uk.expand(lead + (NU,))

    def zeros(rows):
        return torch.zeros(lead + (rows, nxu), dtype=dtype, device=device)

    def bc(p):
        return p.expand(lead)

    # --- linear rows: mass (-dm <= m - m_dry), thrust lb (linearized) -------
    nhat = uk / safe_norm(uk)[..., None]
    G_lin = zeros(2)
    G_lin[..., 0, I_M] = -1.0
    G_lin[..., 1, NX:] = -nhat
    h_lin = torch.stack([xk[..., I_M] - bc(params.m_dry),
                         torch.sum(nhat * uk, dim=-1) - bc(params.T_min)], dim=-1)

    # --- glideslope SOC(3): s = (r1, tan_gs*r2, tan_gs*r3) -----------------
    tgs = bc(params.tan_gamma_gs)
    G_gs = zeros(3)
    G_gs[..., 0, 1] = -1.0
    G_gs[..., 1, 2] = -tgs
    G_gs[..., 2, 3] = -tgs
    h_gs = torch.stack([xk[..., 1], tgs * xk[..., 2], tgs * xk[..., 3]], dim=-1)

    # --- thrust ub SOC(4): T_max >= ||u|| -----------------------------------
    G_tub = zeros(4)
    for i in range(3):
        G_tub[..., 1 + i, NX + i] = -1.0
    h_tub = torch.cat([bc(params.T_max)[..., None], uk], dim=-1)

    return G_lin, h_lin, ((G_gs, h_gs), (G_tub, h_tub))


def initial_guess(params: PointMass3DoFParams, K: int):
    """Straight-line interpolation of BCs + hover thrust.

    Returns X (P..., K, nx), U (P..., K, nu), sigma (P...).
    """
    dtype, device = params.dtype, params.device
    a = torch.linspace(1.0, 0.0, K, dtype=dtype, device=device)[:, None]
    p = params.unsqueeze(1)
    m = a * p.m_wet[..., None] + (1.0 - a) * p.m_dry[..., None]   # (P, K, 1)
    r = a * p.r_init + (1.0 - a) * p.r_final
    v = a * p.v_init + (1.0 - a) * p.v_final
    lead = m.shape[:-1]
    X = torch.cat([m, r.expand(lead + (3,)), v.expand(lead + (3,))], dim=-1)
    U = -m * p.g_i
    return X, U, params.tf_guess


def pointmass3dof_model() -> Model:
    """The 3-DoF point-mass model (one cached instance)."""
    if "m" not in _MODEL:
        _MODEL["m"] = Model(
            name="pointmass3dof",
            nx=NX,
            nu=NU,
            f=dynamics,
            stage_cones=stage_cones,
            n_lin=N_LIN,
            soc_dims=SOC_DIMS,
            mass_index=I_M,
            init_pinned=tuple([True] * NX),
            term_pinned=tuple([False] + [True] * 6),
            term_u_pinned=(False, False, False),
            initial_guess=initial_guess,
            cuda_dynamics=CudaDynamics("pointmass3dof", kernel_params),
        )
    return _MODEL["m"]


_MODEL: dict = {}
