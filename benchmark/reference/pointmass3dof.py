"""Plain reference of the 3-DoF point-mass landing problem (float64).

Written from the problem statement of Acikmese & Ploen (JGCD 30(5), 2007),
in the nondimensional form the benchmark's configuration file states. It
imports only torch and is independent of the program under test.

State x = (m, r_I[3], v_I[3]), inertial up e1; control u = T_I, the
thrust in the inertial frame.

    mdot = -alpha_m ||T||,  rdot = v,  vdot = T / m + g_I

Every node must satisfy: m >= m_dry; T_min <= ||T|| <= T_max; and the
glide slope r_1 >= tan(gamma_gs) ||(r_2, r_3)||. Boundary conditions: the
whole state at the first node; r and v at the last (the mass is free).
"""

from __future__ import annotations

import torch

NX, NU = 7, 3
FIRST = (0, 1, 2, 3, 4, 5, 6)
LAST = (1, 2, 3, 4, 5, 6)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def dynamics(p: dict, x, u):
    """xdot for states (L, N, 7) and controls (L, N, 3); params (L, ...)."""

    def lane(name):
        return p[name].reshape(p[name].shape[:1] + (1,) * (x.dim() - 2)
                               + p[name].shape[1:])

    mdot = -lane("alpha_m") * _norm(u)
    vdot = u / x[..., 0:1] + lane("g_i")
    return torch.cat([mdot[..., None], x[..., 4:7], vdot], -1)


def retract(x):
    return x


def defect_coordinates(x_next, raw):
    del x_next
    return raw


def violation(p: dict, X, U):
    """The worst constraint violation at each node, (L, K)."""

    def lane(name):
        return p[name].reshape(p[name].shape[:1] + (1,) * (X.dim() - 2))

    r = X[..., 1:4]
    thrust = _norm(U)
    rows = [
        lane("m_dry") - X[..., 0],
        lane("T_min") - thrust,
        lane("tan_gamma_gs") * _norm(r[..., 1:]) - r[..., 0],
        thrust - lane("T_max"),
    ]
    return torch.clamp(torch.stack(rows, -1), min=0.0).amax(-1)


def boundary_gap(p: dict, X):
    """The largest gap of a pinned boundary value, (L,)."""
    first = torch.cat([X[:, 0, 0:1] - p["m_wet"][:, None],
                       X[:, 0, 1:4] - p["r_init"], X[:, 0, 4:7] - p["v_init"]],
                      -1)
    last = torch.cat([X[:, -1, 1:4] - p["r_final"],
                      X[:, -1, 4:7] - p["v_final"]], -1)
    return torch.cat([first, last], -1).abs().amax(-1)


def pins(p: dict):
    """Values of the pinned components: (first (L, 7), last (L, 6))."""
    first = torch.cat([p["m_wet"][:, None], p["r_init"], p["v_init"]], -1)
    return first, torch.cat([p["r_final"], p["v_final"]], -1)


def cones(p: dict):
    """As ``rocket6dof.cones``: the dry mass, the thrust's upper bound and
    the glide slope (not at the last node)."""
    L = p["m_wet"].shape[0]
    dt, dev = p["m_wet"].dtype, p["m_wet"].device

    def M(dim, entries):
        out = torch.zeros((L, dim, NX + NU), dtype=dt, device=dev)
        for r, c, v in entries:
            out[:, r, c] = v
        return out

    zero = torch.zeros((L,), dtype=dt, device=dev)
    tg = p["tan_gamma_gs"]
    return [
        (1, M(1, [(0, 0, 1.0)]), (-p["m_dry"])[:, None], True),
        (4, M(4, [(1 + j, NX + j, 1.0) for j in range(3)]),
         torch.stack([p["T_max"], zero, zero, zero], -1), True),
        (3, M(3, [(0, 1, 1.0), (1, 2, tg), (2, 3, tg)]),
         torch.stack([zero, zero, zero], -1), False),
    ]


def initial_guess(p: dict, K: int):
    """Straight lines, as ``rocket6dof.initial_guess``."""
    t = torch.linspace(0.0, 1.0, K, dtype=p["m_wet"].dtype,
                       device=p["m_wet"].device)[None, :, None]
    m0 = p["m_wet"][:, None, None]
    m = m0 + t * (0.5 * (p["m_dry"][:, None, None] - m0))
    r = p["r_init"][:, None] + t * (p["r_final"] - p["r_init"])[:, None]
    v = p["v_init"][:, None] + t * (p["v_final"] - p["v_init"])[:, None]
    X = torch.cat([m, r, v], -1)
    U = -m * p["g_i"][:, None]
    return X, U, p["tf_guess"].clone()
