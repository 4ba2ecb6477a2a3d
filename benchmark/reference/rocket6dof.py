"""Plain reference of the 6-DoF vacuum rocket landing problem (float64).

Written from the problem statement of Szmuk & Acikmese (AIAA 2018-0617),
in the nondimensional form the benchmark's configuration file states. It
imports only torch and is independent of the program under test.

State x = (m, r_I[3], v_I[3], q[4], omega_B[3]), scalar-first unit
quaternion q rotating body vectors into the inertial frame, inertial up e1.
Control u = T_B, the thrust in the body frame.

    mdot     = -alpha_m ||T||
    rdot     = v
    vdot     = (C_IB(q) T - cd_a ||v|| v) / m + g_I
    qdot     = 1/2 q (x) (0, omega)
    omegadot = J^-1 (r_T x T - omega x J omega)

Every node must satisfy: m >= m_dry; T_min <= ||T|| <= T_max; the glide
slope r_1 >= tan(gamma_gs) ||(r_2, r_3)||; the tilt ||(q_2, q_3)|| <=
c_tilt; ||omega|| <= omega_max; and the gimbal ||T|| <= T_1 / cos(delta_max).
Boundary conditions: m, r, v, omega at the first node (the attitude is
free); r, v, q = (1, 0, 0, 0) and omega = 0 at the last (the mass is free).
"""

from __future__ import annotations

import torch

NX, NU = 14, 3
# pinned state components at the first and the last node
FIRST = (0, 1, 2, 3, 4, 5, 6, 11, 12, 13)
LAST = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _dcm(q):
    """C_IB of a scalar-first quaternion (..., 4) -> (..., 3, 3)."""
    q0, q1, q2, q3 = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (q2 * q2 + q3 * q3), 2 * (q1 * q2 - q0 * q3),
                     2 * (q1 * q3 + q0 * q2)], -1),
        torch.stack([2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3),
                     2 * (q2 * q3 - q0 * q1)], -1),
        torch.stack([2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1),
                     1 - 2 * (q1 * q1 + q2 * q2)], -1),
    ], -2)


def dynamics(p: dict, x, u):
    """xdot for states (L, N, 14) and controls (L, N, 3); params (L, ...)."""
    m, v, q, w = x[..., 0], x[..., 4:7], x[..., 7:11], x[..., 11:14]

    def lane(name):
        return p[name].reshape(p[name].shape[:1] + (1,) * (x.dim() - 2)
                               + p[name].shape[1:])

    thrust_i = (_dcm(q) @ u[..., None])[..., 0]
    speed = _norm(v)
    mdot = -lane("alpha_m") * _norm(u)
    vdot = ((thrust_i - (lane("cd_a") * speed)[..., None] * v) / m[..., None]
            + lane("g_i"))
    q0, q1, q2, q3 = q.unbind(-1)
    w1, w2, w3 = w.unbind(-1)
    qdot = 0.5 * torch.stack([-q1 * w1 - q2 * w2 - q3 * w3,
                              q0 * w1 + q2 * w3 - q3 * w2,
                              q0 * w2 - q1 * w3 + q3 * w1,
                              q0 * w3 + q1 * w2 - q2 * w1], -1)
    J = lane("J_b")
    wdot = (torch.linalg.cross(lane("r_t").expand_as(u), u)
            - torch.linalg.cross(w, J * w)) / J
    return torch.cat([mdot[..., None], v, vdot, qdot, wdot], -1)


def retract(x):
    """The state manifold: the quaternion has unit length."""
    q = x[..., 7:11]
    return torch.cat([x[..., :7], q / _norm(q)[..., None], x[..., 11:]], -1)


def defect_coordinates(x_next, raw):
    """The defect in the tangent coordinates of the state manifold at the
    node it lands on: (m, r, v, omega) as they are, the quaternion's error
    in the three directions q (x) e_i."""
    q = x_next[..., 7:11] / _norm(x_next[..., 7:11])[..., None]
    q0, q1, q2, q3 = q.unbind(-1)
    d0, d1, d2, d3 = raw[..., 7:11].unbind(-1)
    dq = torch.stack([-q1 * d0 + q0 * d1 + q3 * d2 - q2 * d3,
                      -q2 * d0 - q3 * d1 + q0 * d2 + q1 * d3,
                      -q3 * d0 + q2 * d1 - q1 * d2 + q0 * d3], -1)
    return torch.cat([raw[..., :7], dq, raw[..., 11:]], -1)


def violation(p: dict, X, U):
    """The worst constraint violation at each node, (L, K)."""

    def lane(name):
        return p[name].reshape(p[name].shape[:1] + (1,) * (X.dim() - 2))

    r, q, w = X[..., 1:4], X[..., 7:11], X[..., 11:14]
    thrust = _norm(U)
    rows = [
        lane("m_dry") - X[..., 0],
        lane("T_min") - thrust,
        lane("tan_gamma_gs") * _norm(r[..., 1:]) - r[..., 0],
        _norm(q[..., 2:]) - lane("c_tilt"),
        _norm(w) - lane("omega_max"),
        thrust - lane("T_max"),
        thrust - U[..., 0] / lane("cos_delta_max"),
    ]
    return torch.clamp(torch.stack(rows, -1), min=0.0).amax(-1)


def boundary_gap(p: dict, X):
    """The largest gap of a pinned boundary value, (L,)."""
    first = torch.cat([X[:, 0, 0:1] - p["m_wet"][:, None],
                       X[:, 0, 1:4] - p["r_init"], X[:, 0, 4:7] - p["v_init"],
                       X[:, 0, 11:14] - p["w_init"]], -1)
    upright = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=X.dtype,
                           device=X.device)
    last = torch.cat([X[:, -1, 1:4] - p["r_final"],
                      X[:, -1, 4:7] - p["v_final"], X[:, -1, 7:11] - upright,
                      X[:, -1, 11:14]], -1)
    return torch.cat([first, last], -1).abs().amax(-1)


def pins(p: dict):
    """Values of the pinned components: (first (L, 10), last (L, 13))."""
    upright = torch.zeros_like(p["r_final"][:, :1]).expand(-1, 4).clone()
    upright[:, 0] = 1.0
    first = torch.cat([p["m_wet"][:, None], p["r_init"], p["v_init"],
                       p["w_init"]], -1)
    last = torch.cat([p["r_final"], p["v_final"], upright,
                      torch.zeros_like(p["w_init"])], -1)
    return first, last


def cones(p: dict):
    """The convex path constraints at each node as affine maps of
    v = (x, u) into cones: (dim, M (L, dim, 17), a (L, dim), at_last), M v
    + a in the cone (dim 1: nonnegative). The glide slope is left out at
    the last node, where r is pinned to its apex."""
    L = p["m_wet"].shape[0]
    z = torch.zeros((L, 1, NX + NU), dtype=p["m_wet"].dtype,
                    device=p["m_wet"].device)

    def rows(*entries):
        """entries: (row, col, value (L,) or float)."""
        dim = 1 + max(r for r, _, _ in entries)
        M = z.expand(L, dim, NX + NU).clone()
        for r, c, v in entries:
            M[:, r, c] = v
        return M

    def vec(*vals):
        return torch.stack([torch.as_tensor(v, dtype=z.dtype,
                                            device=z.device).expand(L)
                            for v in vals], -1)

    u = [(1 + j, NX + j, 1.0) for j in range(3)]
    tg = p["tan_gamma_gs"]
    return [
        (1, rows((0, 0, 1.0)), vec(-p["m_dry"]), True),
        (4, rows(*u), vec(p["T_max"], 0.0, 0.0, 0.0), True),
        (3, rows((0, 1, 1.0), (1, 2, tg), (2, 3, tg)), vec(0.0, 0.0, 0.0),
         False),
        (3, rows((1, 9, 1.0), (2, 10, 1.0)), vec(p["c_tilt"], 0.0, 0.0), True),
        (4, rows(*[(1 + j, 11 + j, 1.0) for j in range(3)]),
         vec(p["omega_max"], 0.0, 0.0, 0.0), True),
        (4, rows((0, NX, 1.0 / p["cos_delta_max"]), *u),
         vec(0.0, 0.0, 0.0, 0.0), True),
    ]


def initial_guess(p: dict, K: int):
    """Straight lines from the first to the last pinned values: the mass
    from wet to halfway to dry, the attitude upright, no rotation, the
    thrust holding the mass against gravity; sigma the guessed time."""
    t = torch.linspace(0.0, 1.0, K, dtype=p["m_wet"].dtype,
                       device=p["m_wet"].device)[None, :, None]
    m0 = p["m_wet"][:, None, None]
    m = m0 + t * (0.5 * (p["m_dry"][:, None, None] - m0))
    r = p["r_init"][:, None] + t * (p["r_final"] - p["r_init"])[:, None]
    v = p["v_init"][:, None] + t * (p["v_final"] - p["v_init"])[:, None]
    q = torch.zeros_like(r[..., :1]).expand(-1, -1, 4).clone()
    q[..., 0] = 1.0
    w = torch.zeros_like(r)
    X = torch.cat([m, r, v, q, w], -1)
    U = -m * p["g_i"][:, None]
    return X, U, p["tf_guess"].clone()
