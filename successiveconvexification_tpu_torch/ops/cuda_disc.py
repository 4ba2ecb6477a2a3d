"""CUDA kernel for the RK4 multiple-shooting linearization (csrc/disc.cu).

The counterpart of the JAX package's ``ops/pallas_disc.py``:

  - ``discretize_lanes``: every interval's augmented RK4 integration in ONE
    launch, a warp per (scenario, interval) lane (replaces
    ``pallas_disc.discretize_lanes``);
  - ``discretize_lanes_plain``: the same function in plain PyTorch, the
    Jacobians by ``Model.f_and_jacobians`` (forward mode).

Both take X (..., K, nx), U (..., K, nu), sigma (...) and params whose batch
shape broadcasts against X's leading dimensions, and return
``(A, Bm, Bp, S, z, x_end)``: A = Phi(h) (..., K-1, nx, nx), Bm, Bp
(..., K-1, nx, nu), S, z, x_end (..., K-1, nx), with Bm, Bp, S and z already
multiplied by Phi(h) (the retraction is ``discretize``'s, outside).
``discretize`` takes the kernel for CUDA tensors and the plain version for
CPU tensors; the kernel wrapper raises on anything else, and on a model
whose dynamics the kernel does not have (``Model.cuda_dynamics`` is None).
The kernel is instantiated once per model's dynamics; the model names its
instantiation (``Model.cuda_dynamics.name``).
``discretize_lanes.launches`` counts the kernel launches of every model.
"""

from __future__ import annotations

import torch

from successiveconvexification_tpu_torch.ops import _build
from successiveconvexification_tpu_torch.ops.integrate import mv, rk4


def kernel_dynamics(model) -> str:
    """The name of ``model``'s dynamics in csrc/disc.cu; raises for a model
    the kernel does not have."""
    if model.cuda_dynamics is None:
        raise ValueError(f"discretize_lanes: model {model.name!r} has no CUDA "
                         "dynamics (Model.cuda_dynamics is None)")
    return model.cuda_dynamics.name


def discretize_lanes_plain(model, params, X: torch.Tensor, U: torch.Tensor,
                           sigma: torch.Tensor, substeps: int,
                           foh: bool = True):
    """Every interval's augmented RK4 integration in plain PyTorch: the K-1
    intervals integrate together as one batch beside the scenario axis,
    with one forward-mode pass through the dynamics per RK stage."""
    K, nx = X.shape[-2], X.shape[-1]
    nu = model.nu
    h = 1.0 / (K - 1)
    p1 = params.unsqueeze(1)
    sig = sigma[..., None]
    xk, uk, ukp1 = X[..., :-1, :], U[..., :-1, :], U[..., 1:, :]
    lead = xk.shape[:-1]
    dtype, device = X.dtype, X.device

    def aug_dot(tau, aug):
        x, Phi, P, Bm, Bp, S, z = aug
        lam_p = tau / h if foh else 0.0
        lam_m = 1.0 - lam_p
        u = lam_m * uk + lam_p * ukp1
        fv, Ac, Bc = model.f_and_jacobians(p1, x, u)
        sA = sig[..., None, None] * Ac
        sB = sig[..., None, None] * Bc
        PsB = P @ sB
        return [
            sig[..., None] * fv,
            sA @ Phi,
            -(P @ sA),
            lam_m * PsB,
            lam_p * PsB,
            mv(P, fv),
            -mv(P, mv(sA, x) + mv(sB, u)),
        ]

    eye = torch.eye(nx, dtype=dtype, device=device).expand(lead + (nx, nx))
    aug = [
        xk, eye, eye,
        torch.zeros(lead + (nx, nu), dtype=dtype, device=device),
        torch.zeros(lead + (nx, nu), dtype=dtype, device=device),
        torch.zeros(lead + (nx,), dtype=dtype, device=device),
        torch.zeros(lead + (nx,), dtype=dtype, device=device),
    ]
    x_end, Phi, _, Bm, Bp, S, z = rk4(aug_dot, aug, substeps, h)
    return Phi, Phi @ Bm, Phi @ Bp, mv(Phi, S), mv(Phi, z), x_end


def discretize_lanes(model, params, X: torch.Tensor, U: torch.Tensor,
                     sigma: torch.Tensor, substeps: int, foh: bool = True):
    """The kernel: one launch, a warp per (scenario, interval) lane.

    ``model.cuda_dynamics`` names the instantiation and packs the fields
    its dynamics read, (P..., n)."""
    dyn = kernel_dynamics(model)
    pk = model.cuda_dynamics.pack(params)
    ts = (X, U, sigma, pk)
    if len({t.dtype for t in ts}) > 1:
        raise ValueError("discretize_lanes: mixed dtypes "
                         f"{[t.dtype for t in ts]}")
    sfx = _build.suffix("discretize_lanes", *ts)
    K, nx, nu = X.shape[-2], X.shape[-1], U.shape[-1]
    lead = X.shape[:-2]
    if (nx, nu) != (model.nx, model.nu) or U.shape[:-1] != X.shape[:-1] \
            or K < 2:
        raise ValueError(f"discretize_lanes: shapes {tuple(X.shape)}, "
                         f"{tuple(U.shape)}")
    Xc, Uc = X.contiguous(), U.contiguous()
    sg = sigma.expand(lead).contiguous()
    pkc = pk.expand(lead + pk.shape[-1:]).contiguous()
    Bn = Xc.numel() // (K * nx)

    def out(*tail):
        return torch.empty(lead + (K - 1,) + tail, dtype=X.dtype,
                           device=X.device)

    A, Bm, Bp = out(nx, nx), out(nx, nu), out(nx, nu)
    S, z, x_end = out(nx), out(nx), out(nx)
    fn = _build.declare(_build.library("disc"),
                        f"scvx_discretize_lanes_{dyn}_{sfx}", 10, 4)
    err = fn(pkc.data_ptr(), Xc.data_ptr(), Uc.data_ptr(), sg.data_ptr(),
             A.data_ptr(), Bm.data_ptr(), Bp.data_ptr(), S.data_ptr(),
             z.data_ptr(), x_end.data_ptr(), Bn, K, substeps, int(bool(foh)),
             torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "discretize_lanes")
    discretize_lanes.launches += 1
    return A, Bm, Bp, S, z, x_end


discretize_lanes.launches = 0
