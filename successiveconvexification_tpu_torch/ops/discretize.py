"""RK4 multiple-shooting discretization of the linearized, time-dilated dynamics.

The PyTorch counterpart of the JAX package's ``ops/discretize.py``. For every
interval [tau_k, tau_{k+1}] (tau in [0, 1], free final time via sigma):

    x_{k+1} ≈ A_k x_k + Bm_k u_k + Bp_k u_{k+1} + S_k sigma + z_k

by integrating the augmented ODE with fixed-step RK4 and first-order-hold
controls:

    xdot   = sigma * f(x, u(tau))
    Phidot = sigma * A Phi,        Pdot  = -sigma * P A      (P = Phi^-1)
    Bmdot  = lam_m * sigma * P B,  Bpdot = lam_p * sigma * P B
    Sdot   = P f,                  zdot  = -sigma * P (A x + B u)

The K-1 intervals are independent, one lane each beside the scenario axis.
On the card they integrate in one kernel launch (``cuda_disc.discretize_lanes``,
csrc/disc.cu, the counterpart of the JAX package's ``pallas_disc``); on the
CPU in its plain PyTorch version (``cuda_disc.discretize_lanes_plain``). The
tensors' device alone picks between them. The retraction composition and
``propagate`` stay plain PyTorch, where the JAX package has them outside any
kernel too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from successiveconvexification_tpu_torch.models.base import Model
from successiveconvexification_tpu_torch.ops import cuda_disc
from successiveconvexification_tpu_torch.ops.integrate import mv, rk4


class Discretization(NamedTuple):
    """Per-interval affine discrete dynamics, node axis K-1 after the batch."""

    A: torch.Tensor       # (..., K-1, nx, nx)
    Bm: torch.Tensor      # (..., K-1, nx, nu)
    Bp: torch.Tensor      # (..., K-1, nx, nu)
    S: torch.Tensor       # (..., K-1, nx)
    z: torch.Tensor       # (..., K-1, nx)
    x_prop: torch.Tensor  # (..., K-1, nx)
    defect: torch.Tensor  # (..., K-1, nx)


def discretize(model: Model, params, X: torch.Tensor, U: torch.Tensor,
               sigma: torch.Tensor, substeps: int,
               foh: bool = True) -> Discretization:
    """Discretize every interval of the trajectory.

    X (..., K, nx), U (..., K, nu), sigma (...); params with batch shape
    broadcasting against ``X.shape[:-2]``.
    """
    lanes = (cuda_disc.discretize_lanes_plain if X.device.type == "cpu"
             else cuda_disc.discretize_lanes)
    A, Bm, Bp, S, z, x_end = lanes(model, params, X, U, sigma, substeps, foh)
    x_prop = x_end
    if model.project_jac is not None:
        # retraction-composed flow: x_{k+1} = P(phi) ~ P(y) + Jp (phi - y)
        Jp = model.project_jac(x_prop)
        y = x_prop
        x_prop = model.project_state(x_prop)
        A = Jp @ A
        Bm = Jp @ Bm
        Bp = Jp @ Bp
        S = mv(Jp, S)
        z = mv(Jp, z) + (x_prop - mv(Jp, y))
    defect = x_prop - X[..., 1:, :]
    return Discretization(A=A, Bm=Bm, Bp=Bp, S=S, z=z, x_prop=x_prop,
                          defect=defect)


def propagate(model: Model, params, X: torch.Tensor, U: torch.Tensor,
              sigma: torch.Tensor, substeps: int, foh: bool = True):
    """Nonlinear multiple-shooting propagation: (..., K-1, nx) end states."""
    K = X.shape[-2]
    h = 1.0 / (K - 1)
    p1 = params.unsqueeze(1)
    sig = sigma[..., None, None]
    uk, ukp1 = U[..., :-1, :], U[..., 1:, :]

    def xdot(tau, aug):
        lam_p = tau / h if foh else 0.0
        u = (1.0 - lam_p) * uk + lam_p * ukp1
        return [sig * model.f(p1, aug[0], u)]

    (x_end,) = rk4(xdot, [X[..., :-1, :]], substeps, h)
    if model.project_jac is not None:
        x_end = model.project_state(x_end)
    return x_end


def _hillis_steele(combine, elems, dims):
    """Inclusive scan of an associative ``combine(earlier, later)`` over the
    interval axis (``dims[i]`` of ``elems[i]``) in log2(N) rounds: at
    stride d every entry i >= d takes combine(entry i-d, entry i). The JAX
    package uses ``associative_scan`` here, outside any kernel."""
    N = elems[0].shape[dims[0]]
    d = 1
    while d < N:
        early = [e.narrow(dm, 0, N - d) for e, dm in zip(elems, dims)]
        late = [e.narrow(dm, d, N - d) for e, dm in zip(elems, dims)]
        elems = [torch.cat([e.narrow(dm, 0, d), c], dim=dm)
                 for e, c, dm in zip(elems, combine(early, late), dims)]
        d *= 2
    return elems


def _affine_compose(e1, e2):
    """Compose batched affine maps: e1 = (A1, c1) applied FIRST, then e2:
    (A2, c2) o (A1, c1) = (A2 A1, A2 c1 + c2)."""
    A1, c1 = e1
    A2, c2 = e2
    return A2 @ A1, mv(A2, c1) + c2


def condense(disc: Discretization) -> torch.Tensor:
    """Cumulative state-transition matrices, (..., K-1, nx, nx):
    Phi[k] = A_k A_{k-1} ... A_0, the map from a node-0 perturbation to the
    node-(k+1) perturbation under the discretized linear dynamics, composed
    in log depth."""
    (Phi,) = _hillis_steele(lambda a, b: [b[0] @ a[0]], [disc.A], [-3])
    return Phi


def linear_rollout(disc: Discretization, x0: torch.Tensor, U: torch.Tensor,
                   sigma: torch.Tensor) -> torch.Tensor:
    """Single-shooting rollout of the discrete affine dynamics, log depth.

    Composes x_{k+1} = A_k x_k + Bm_k u_k + Bp_k u_{k+1} + S_k sigma + z_k
    over the horizon as one scan of affine maps. x0 (..., nx), U (..., K, nu),
    sigma (...). Returns (..., K-1, nx): the states at nodes 1..K-1."""
    c = (mv(disc.Bm, U[..., :-1, :]) + mv(disc.Bp, U[..., 1:, :])
         + disc.S * sigma[..., None, None] + disc.z)
    Phi, ccum = _hillis_steele(_affine_compose, [disc.A, c], [-3, -2])
    return mv(Phi, x0[..., None, :]) + ccum
