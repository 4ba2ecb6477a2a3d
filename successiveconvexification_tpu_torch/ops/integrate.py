"""Plain fixed-step integration helpers shared by the discretize module and
the discretize kernel's plain version."""

from __future__ import annotations

import torch


def mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., n, m) x (..., m) -> (..., n)."""
    return (M @ v[..., None])[..., 0]


def rk4(step_fn, aug, substeps: int, h: float):
    """Fixed-step RK4 over [0, h] of the list of tensors ``aug``;
    ``step_fn(tau, aug)`` gives their derivatives."""
    dt = h / substeps
    for i in range(substeps):
        tau = i * dt
        k1 = step_fn(tau, aug)
        k2 = step_fn(tau + dt / 2, [a + dt / 2 * k for a, k in zip(aug, k1)])
        k3 = step_fn(tau + dt / 2, [a + dt / 2 * k for a, k in zip(aug, k2)])
        k4 = step_fn(tau + dt, [a + dt * k for a, k in zip(aug, k3)])
        aug = [a + dt / 6 * (a1 + 2 * a2 + 2 * a3 + a4)
               for a, a1, a2, a3, a4 in zip(aug, k1, k2, k3, k4)]
    return aug
