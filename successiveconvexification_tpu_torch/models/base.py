"""Model abstraction: continuous dynamics + per-stage convex constraint builder.

The PyTorch counterpart of the JAX package's ``models/base.py``. A ``Model`` is
a static descriptor of one vehicle family; its numeric parameters live in a
separate params object of tensors with a leading batch axis.

Every model function takes tensors with any number of leading batch
dimensions (``x`` is ``(..., nx)``), and params whose fields broadcast against
those leading dimensions — the explicit batch axis that replaces ``jax.vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """Static problem-family descriptor. Instances are compared by identity."""

    name: str
    nx: int
    nu: int
    f: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]
    # (params, xk, uk) -> (G_lin (..., n_lin, nx+nu), h_lin (..., n_lin),
    #                      tuple of (G_soc (..., d, nx+nu), h_soc (..., d)))
    stage_cones: Callable
    n_lin: int
    soc_dims: Tuple[int, ...]
    mass_index: int | None
    init_pinned: Tuple[bool, ...]
    term_pinned: Tuple[bool, ...]
    term_u_pinned: Tuple[bool, ...]
    initial_guess: Callable
    project_state: Callable[[torch.Tensor], torch.Tensor] | None = None
    # Jacobian of the per-state retraction: (..., nx) -> (..., nx, nx)
    project_jac: Callable[[torch.Tensor], torch.Tensor] | None = None
    # per-node tangent basis (params, xk (..., nx)) -> (..., nx, nr)
    state_basis: Callable[[Any, torch.Tensor], torch.Tensor] | None = None
    nr: int = -1
    init_pinned_r: Tuple[bool, ...] = ()
    term_pinned_r: Tuple[bool, ...] = ()
    # params -> (P..., n), the fields the discretize kernel's dynamics read
    # per scenario; set exactly when csrc/disc.cu has this model's dynamics
    cuda_params: Callable[[Any], torch.Tensor] | None = None

    def f_and_jacobians(self, params, x: torch.Tensor, u: torch.Tensor):
        """(f, A, B) = (f(x,u), df/dx, df/du), batched over leading dims.

        Forward-mode AD, exact like the JAX package's ``jax.jacfwd``: the
        nx+nu one-hot tangent directions are folded into one extra LEADING
        axis, so a single ``torch.func.jvp`` through the batched dynamics
        yields every Jacobian column at once (the lane fan-out of the JAX
        package's ``_aug_rk4_soa``).
        """
        nx, nu = self.nx, self.nu
        nc = nx + nu
        eye = torch.eye(nc, dtype=x.dtype, device=x.device)
        lead = (1,) * (x.dim() - 1)
        shape = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        tx = eye[:, :nx].reshape((nc,) + lead + (nx,)).expand(
            (nc,) + shape + (nx,)).contiguous()
        tu = eye[:, nx:].reshape((nc,) + lead + (nu,)).expand(
            (nc,) + shape + (nu,)).contiguous()
        xr = x.expand((nc,) + shape + (nx,)).contiguous()
        ur = u.expand((nc,) + shape + (nu,)).contiguous()
        fr, dv = torch.func.jvp(lambda xx, uu: self.f(params, xx, uu),
                                (xr, ur), (tx, tu))
        # dv[j] is column j of [A | B]: move the tangent axis last
        J = torch.movedim(dv, 0, -1)
        return fr[0], J[..., :nx], J[..., nx:]

    def jacobians(self, params, x, u):
        """(A, B) = (df/dx, df/du) via forward-mode AD."""
        _, A, B = self.f_and_jacobians(params, x, u)
        return A, B


def safe_norm(v: torch.Tensor, eps: float = 1e-12, dim=-1) -> torch.Tensor:
    """||v|| with a nonzero subgradient at 0 (keeps the Jacobian finite)."""
    return torch.sqrt(torch.sum(v * v, dim=dim) + eps)
