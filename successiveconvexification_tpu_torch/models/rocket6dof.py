"""6-DoF quaternion rocket powered-descent model (Szmuk-Acikmese), PyTorch port.

State (nx=14):  x = (m, r_I[3], v_I[3], q_{I<-B}[4], omega_B[3]), inertial up = e1.
Control (nu=3): u = T_B, thrust vector in the body frame.

    mdot     = -alpha_m * ||T||
    rdot     = v
    vdot     = (C_IB(q) T - cd_a ||v|| v) / m + g_I
    qdot     = 0.5 * q ⊗ (0, omega)
    omegadot = J^-1 (r_T x T - omega x J omega)

Per-node cones (deltas about (xbar, ubar)): mass and linearized thrust lower
bound (linear), glideslope SOC(3), tilt SOC(3), rate SOC(4), thrust upper
bound SOC(4), gimbal SOC(4) — the same rows as the JAX package's model.
``rocket6dof_model(aoa_stc=True)`` adds a third linear row, the linearized
angle-of-attack state-triggered constraint (``_aoa_stc_scalar``). Drag
(``cd_a > 0``) is in the dynamics of both variants.

Every function is batched over leading dimensions. Params fields have a batch
shape ``P`` (``()`` unbatched, ``(B,)`` for a dispersion batch) that must
broadcast against the leading dimensions of the state tensors; use
``Rocket6DoFParams.unsqueeze(n)`` to insert node axes after ``P``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from successiveconvexification_tpu_torch.models.base import (
    CudaDynamics,
    Model,
    Params,
    safe_norm,
)
from successiveconvexification_tpu_torch.utils.quaternion import (
    cross,
    quat_kinematics,
    quat_normalize,
    quat_to_dcm,
)

NX = 14
NU = 3

I_M = 0
I_R = slice(1, 4)
I_V = slice(4, 7)
I_Q = slice(7, 11)
I_W = slice(11, 14)

# trailing (non-batch) shape of every params field
_FIELD_TAIL = {
    "m_wet": (), "m_dry": (), "alpha_m": (), "T_min": (), "T_max": (),
    "cos_delta_max": (), "tan_gamma_gs": (), "c_tilt": (), "omega_max": (),
    "J_b": (3,), "r_t": (3,), "g_i": (3,), "cd_a": (), "v_trigger": (),
    "cos_aoa_max": (), "r_init": (3,), "v_init": (3,), "q_init": (4,),
    "w_init": (3,), "r_final": (3,), "v_final": (3,), "tf_guess": (),
}


@dataclasses.dataclass(frozen=True)
class Rocket6DoFParams(Params):
    """Physical parameters: tensors with a common leading batch shape."""

    TAIL = _FIELD_TAIL

    m_wet: torch.Tensor
    m_dry: torch.Tensor
    alpha_m: torch.Tensor
    T_min: torch.Tensor
    T_max: torch.Tensor
    cos_delta_max: torch.Tensor
    tan_gamma_gs: torch.Tensor
    c_tilt: torch.Tensor
    omega_max: torch.Tensor
    J_b: torch.Tensor
    r_t: torch.Tensor
    g_i: torch.Tensor
    cd_a: torch.Tensor
    v_trigger: torch.Tensor
    cos_aoa_max: torch.Tensor
    r_init: torch.Tensor
    v_init: torch.Tensor
    q_init: torch.Tensor
    w_init: torch.Tensor
    r_final: torch.Tensor
    v_final: torch.Tensor
    tf_guess: torch.Tensor


def default_params(dtype=torch.float32, device="cpu") -> Rocket6DoFParams:
    """Nondimensional benchmark landing scenario (unbatched)."""

    def f(*v):
        return torch.tensor(v if len(v) > 1 else v[0], dtype=dtype, device=device)

    deg = math.pi / 180.0
    return Rocket6DoFParams(
        m_wet=f(2.0),
        m_dry=f(1.0),
        alpha_m=f(0.07),
        T_min=f(0.3),
        T_max=f(5.0),
        cos_delta_max=f(math.cos(20.0 * deg)),
        tan_gamma_gs=f(math.tan(20.0 * deg)),
        c_tilt=f(math.sqrt((1.0 - math.cos(90.0 * deg)) / 2.0)),
        omega_max=f(60.0 * deg),
        J_b=f(1e-2, 1e-2, 1e-2),
        r_t=f(-1e-2, 0.0, 0.0),
        g_i=f(-1.0, 0.0, 0.0),
        cd_a=f(0.0),
        v_trigger=f(1.5),
        cos_aoa_max=f(math.cos(30.0 * deg)),
        r_init=f(4.0, 4.0, 0.0),
        v_init=f(-0.5, -2.0, 0.0),
        q_init=f(1.0, 0.0, 0.0, 0.0),
        w_init=f(0.0, 0.0, 0.0),
        r_final=f(0.0, 0.0, 0.0),
        v_final=f(-1e-1, 0.0, 0.0),
        tf_guess=f(6.0),
    )


def params_from_numpy(d: Mapping, device="cpu",
                      dtype=torch.float64) -> Rocket6DoFParams:
    """Build port params from a mapping of field name -> numpy array (the
    JAX package's params carry across this way; ``Params.from_numpy``)."""
    return Rocket6DoFParams.from_numpy(d, device=device, dtype=dtype)


def state_from_numpy(st, device="cpu", dtype=torch.float64):
    """Build a port ``ScvxState`` (with its IPM carry) from numpy arrays.

    ``st`` has the JAX package's ``ScvxState`` layout with every leaf a
    numpy array (``jax.tree.map(np.asarray, state)``): attribute access by
    field name, a ``Primal`` under ``ipm_carry.x`` and dicts of cone blocks
    under ``ipm_carry.s`` / ``ipm_carry.z``.
    """
    from successiveconvexification_tpu_torch.ops import ipm, scvx, socp

    def conv(a):
        a = np.array(a)
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int32), device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    c = st.ipm_carry
    carry = ipm.IPMState(
        x=socp.Primal(*(conv(getattr(c.x, f)) for f in socp.Primal._fields)),
        y=conv(c.y),
        s={k: conv(v) for k, v in c.s.items()},
        z={k: conv(v) for k, v in c.z.items()},
        **{f: conv(getattr(c, f)) for f in ipm.IPMState._fields
           if f not in ("x", "y", "s", "z")},
    )
    return scvx.ScvxState(**{
        f: (carry if f == "ipm_carry" else conv(getattr(st, f)))
        for f in scvx.ScvxState._fields
    })


def dynamics(params: Rocket6DoFParams, x: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    m = x[..., I_M]
    v = x[..., I_V]
    q = x[..., I_Q]
    w = x[..., I_W]

    C_ib = quat_to_dcm(q)
    thrust_i = torch.sum(C_ib * u[..., None, :], dim=-1)

    mdot = -params.alpha_m * safe_norm(u)
    rdot = v
    drag_i = -(params.cd_a * safe_norm(v))[..., None] * v
    vdot = (thrust_i + drag_i) / m[..., None] + params.g_i
    qdot = quat_kinematics(q, w)
    Jw = params.J_b * w
    wdot = (cross(params.r_t, u) - cross(w, Jw)) / params.J_b
    parts = [mdot[..., None], rdot, vdot, qdot, wdot]
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], dim=-1)


# the fields csrc/disc.cu's rocket6dof dynamics read, in its order
KERNEL_FIELDS = ("alpha_m", "cd_a", "g_i", "J_b", "r_t")


def kernel_params(params: Rocket6DoFParams) -> torch.Tensor:
    """(P..., 11): alpha_m, cd_a, g_i, J_b, r_t of every scenario in one
    contiguous array; fields of batch shape () or broadcast are expanded to
    the common batch shape."""
    parts = [(getattr(params, k), _FIELD_TAIL[k]) for k in KERNEL_FIELDS]
    lead = torch.broadcast_shapes(*(v.shape[:v.dim() - len(t)]
                                    for v, t in parts))
    return torch.cat([v.expand(lead + t).reshape(lead + (-1,))
                      for v, t in parts], dim=-1)


# --------------------------------------------------------------------------- cones
N_LIN = 2                      # mass lower bound, linearized thrust lower bound
SOC_DIMS = (3, 3, 4, 4, 4)     # glideslope, tilt, rate, thrust-ub, gimbal


def stage_cones(params: Rocket6DoFParams, xk: torch.Tensor, uk: torch.Tensor):
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

    # --- tilt SOC(3): c_tilt >= ||(q2, q3)|| --------------------------------
    G_tilt = zeros(3)
    G_tilt[..., 1, 9] = -1.0
    G_tilt[..., 2, 10] = -1.0
    h_tilt = torch.stack([bc(params.c_tilt), xk[..., 9], xk[..., 10]], dim=-1)

    # --- rate SOC(4): omega_max >= ||omega|| --------------------------------
    G_rate = zeros(4)
    for i in range(3):
        G_rate[..., 1 + i, 11 + i] = -1.0
    h_rate = torch.cat([bc(params.omega_max)[..., None], xk[..., I_W]], dim=-1)

    # --- thrust ub SOC(4): T_max >= ||u|| -----------------------------------
    G_tub = zeros(4)
    for i in range(3):
        G_tub[..., 1 + i, NX + i] = -1.0
    h_tub = torch.cat([bc(params.T_max)[..., None], uk], dim=-1)

    # --- gimbal SOC(4): u_1 / cos(delta_max) >= ||u|| -----------------------
    cdm = bc(params.cos_delta_max)
    G_gim = zeros(4)
    G_gim[..., 0, NX] = -1.0 / cdm
    for i in range(3):
        G_gim[..., 1 + i, NX + i] = -1.0
    h_gim = torch.cat([(uk[..., 0] / cdm)[..., None], uk], dim=-1)

    return G_lin, h_lin, ((G_gs, h_gs), (G_tilt, h_tilt), (G_rate, h_rate),
                          (G_tub, h_tub), (G_gim, h_gim))


# margin added to every linearized STC row's right-hand side: where the
# trigger is off, h = -min(g, 0) c is identically 0 and the row would read
# 0'd <= 0, which has no strict interior for the IPM; the nonlinear merit
# reads the same rows, so both see the margin
STC_EPS = 1e-6


def _aoa_stc_scalar(params: Rocket6DoFParams, x: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Continuous state-triggered angle-of-attack constraint h(x) <= 0:

        trigger     g(x) = v_trigger - ||v||        (enforced where g < 0)
        constraint  c(x) = cos(alpha_max) ||v|| + e1 . C_BI(q) v
        STC         h(x) = -min(g(x), 0) c(x)

    c <= 0 says the body +x axis is within alpha_max of the airflow (-v).
    Batched over leading dimensions; ``u`` is not read.
    """
    del u
    v = x[..., I_V]
    speed = safe_norm(v)
    g = params.v_trigger - speed
    # e1 . C_BI v = (first column of C_IB) . v
    v_b0 = torch.sum(quat_to_dcm(x[..., I_Q])[..., :, 0] * v, dim=-1)
    c = params.cos_aoa_max * speed + v_b0
    # torch.minimum, not clamp: at g = 0 its derivative is 0.5, as jax.grad
    # of jnp.minimum gives (clamp's is 1)
    return -torch.minimum(g, torch.zeros_like(g)) * c


def _aoa_stc_row(params: Rocket6DoFParams, xk: torch.Tensor,
                 uk: torch.Tensor):
    """The STC scalar linearized about (xk, uk): G (..., 1, nx+nu) and
    h (..., 1) with G @ (dx, du) <= h = -h(xbar) + STC_EPS. G is the
    gradient by reverse mode, one pullback for every node at once (each
    node's scalar depends on its own state only)."""
    lead = torch.broadcast_shapes(xk.shape[:-1], uk.shape[:-1],
                                  params.batch_shape)
    xu = torch.cat([xk.expand(lead + (NX,)), uk.expand(lead + (NU,))], dim=-1)
    h, pullback = torch.func.vjp(
        lambda a: _aoa_stc_scalar(params, a[..., :NX], a[..., NX:]), xu)
    (G,) = pullback(torch.ones_like(h))
    return G[..., None, :], (STC_EPS - h)[..., None]


def stage_cones_aoa_stc(params: Rocket6DoFParams, xk: torch.Tensor,
                        uk: torch.Tensor):
    """``stage_cones`` and the linearized STC row (three linear rows)."""
    G_lin, h_lin, socs = stage_cones(params, xk, uk)
    G_stc, h_stc = _aoa_stc_row(params, xk, uk)
    return (torch.cat([G_lin, G_stc], dim=-2),
            torch.cat([h_lin, h_stc], dim=-1), socs)


def initial_guess(params: Rocket6DoFParams, K: int):
    """Straight-line interpolation of BCs + hover-ish thrust.

    Returns X (P..., K, nx), U (P..., K, nu), sigma (P...).
    """
    dtype, device = params.dtype, params.device
    a = torch.linspace(1.0, 0.0, K, dtype=dtype, device=device)[:, None]
    p = params.unsqueeze(1)
    m = a * p.m_wet[..., None] + (1.0 - a) * p.m_dry[..., None]   # (P, K, 1)
    r = a * p.r_init + (1.0 - a) * p.r_final
    v = a * p.v_init + (1.0 - a) * p.v_final
    lead = m.shape[:-1]
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                     device=device).expand(lead + (4,))
    w = torch.zeros(lead + (3,), dtype=dtype, device=device)
    X = torch.cat([m, r.expand(lead + (3,)), v.expand(lead + (3,)), q, w], dim=-1)
    U = -m * p.g_i
    return X, U, params.tf_guess


def project_state(X: torch.Tensor) -> torch.Tensor:
    """Renormalize the quaternion block (attitude lives on S^3)."""
    return torch.cat([X[..., :7], quat_normalize(X[..., 7:11]), X[..., 11:]],
                     dim=-1)


def project_jac(x: torch.Tensor) -> torch.Tensor:
    """d(project_state)/dx: identity except (I - qhat qhat') / ||q|| on q."""
    J = torch.eye(NX, dtype=x.dtype, device=x.device).expand(
        x.shape[:-1] + (NX, NX)).clone()
    q = x[..., I_Q]
    n = torch.sqrt(torch.sum(q * q, dim=-1))
    qhat = q / n[..., None]
    eye4 = torch.eye(4, dtype=x.dtype, device=x.device)
    J[..., 7:11, 7:11] = (eye4 - qhat[..., :, None] * qhat[..., None, :]) / n[
        ..., None, None]
    return J


def state_basis(params: Rocket6DoFParams, xk: torch.Tensor) -> torch.Tensor:
    """Per-node tangent basis (..., 14, 13): identity on (m, r, v, omega) and
    the orthonormal quaternion tangent basis q ⊗ e_i on the q block."""
    del params
    q = xk[..., I_Q] / torch.sqrt(torch.sum(xk[..., I_Q] ** 2, dim=-1))[..., None]
    q0, q1, q2, q3 = q.unbind(-1)
    Vq = torch.stack(
        [
            torch.stack([-q1, -q2, -q3], dim=-1),
            torch.stack([q0, -q3, q2], dim=-1),
            torch.stack([q3, q0, -q1], dim=-1),
            torch.stack([-q2, q1, q0], dim=-1),
        ],
        dim=-2,
    )
    B = torch.zeros(xk.shape[:-1] + (NX, NX - 1), dtype=xk.dtype,
                    device=xk.device)
    idx7 = torch.arange(7, device=xk.device)
    B[..., idx7, idx7] = 1.0
    B[..., 7:11, 7:10] = Vq
    idx3 = torch.arange(3, device=xk.device)
    B[..., 11 + idx3, 10 + idx3] = 1.0
    return B


def rocket6dof_model(aoa_stc: bool = False) -> Model:
    """The 6-DoF model; ``aoa_stc=True`` adds the angle-of-attack
    state-triggered constraint row. One cached instance per flag value."""
    key = bool(aoa_stc)
    if key not in _MODELS:
        _MODELS[key] = Model(
            name="rocket6dof_stc" if key else "rocket6dof",
            nx=NX,
            nu=NU,
            f=dynamics,
            stage_cones=stage_cones_aoa_stc if key else stage_cones,
            n_lin=N_LIN + (1 if key else 0),
            soc_dims=SOC_DIMS,
            mass_index=I_M,
            init_pinned=tuple([True] * 7 + [False] * 4 + [True] * 3),
            term_pinned=tuple([False] + [True] * 13),
            term_u_pinned=(False, False, False),
            initial_guess=initial_guess,
            project_state=project_state,
            project_jac=project_jac,
            state_basis=state_basis,
            nr=NX - 1,
            init_pinned_r=tuple([True] * 7 + [False] * 3 + [True] * 3),
            term_pinned_r=tuple([False] + [True] * 12),
            cuda_dynamics=CudaDynamics("rocket6dof", kernel_params),
        )
    return _MODELS[key]


_MODELS: dict = {}


def get_model() -> Model:
    return rocket6dof_model()
