"""Quaternion algebra for the 6-DoF attitude states (PyTorch port).

Convention (the same as the JAX package): quaternions are scalar-first
``q = (q0, q1, q2, q3)`` unit quaternions representing the rotation BODY ->
INERTIAL, i.e. ``v_I = C_IB(q) @ v_B`` and ``qdot = 0.5 * q ⊗ (0, omega_B)``.
Inertial "up" is e1.

Every function works on any number of leading batch dimensions.
"""

from __future__ import annotations

import math

import torch


def quat_multiply(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product p ⊗ q, scalar-first."""
    p0, p1, p2, p3 = p.unbind(-1)
    q0, q1, q2, q3 = q.unbind(-1)
    return torch.stack(
        [
            p0 * q0 - p1 * q1 - p2 * q2 - p3 * q3,
            p0 * q1 + p1 * q0 + p2 * q3 - p3 * q2,
            p0 * q2 - p1 * q3 + p2 * q0 + p3 * q1,
            p0 * q3 + p1 * q2 - p2 * q1 + p3 * q0,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quat_to_dcm(q: torch.Tensor) -> torch.Tensor:
    """Direction cosine matrix C_IB (..., 3, 3); does not renormalize."""
    q0, q1, q2, q3 = q.unbind(-1)
    r0 = torch.stack([1.0 - 2.0 * (q2 * q2 + q3 * q3),
                      2.0 * (q1 * q2 - q0 * q3),
                      2.0 * (q1 * q3 + q0 * q2)], dim=-1)
    r1 = torch.stack([2.0 * (q1 * q2 + q0 * q3),
                      1.0 - 2.0 * (q1 * q1 + q3 * q3),
                      2.0 * (q2 * q3 - q0 * q1)], dim=-1)
    r2 = torch.stack([2.0 * (q1 * q3 - q0 * q2),
                      2.0 * (q2 * q3 + q0 * q1),
                      1.0 - 2.0 * (q1 * q1 + q2 * q2)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def quat_kinematics(q: torch.Tensor, omega_b: torch.Tensor) -> torch.Tensor:
    """qdot = 0.5 * q ⊗ (0, omega_B) for q = q_{I<-B}."""
    zero = torch.zeros_like(omega_b[..., :1])
    return 0.5 * quat_multiply(q, torch.cat([zero, omega_b], dim=-1))


def quat_rotate(q: torch.Tensor, v_b: torch.Tensor) -> torch.Tensor:
    """Rotate a body-frame vector into the inertial frame: q ⊗ (0,v) ⊗ q*."""
    zero = torch.zeros_like(v_b[..., :1])
    vq = torch.cat([zero, v_b], dim=-1)
    return quat_multiply(quat_multiply(q, vq), quat_conjugate(q))[..., 1:]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis, broadcasting the leading ones."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix: skew(v) @ w == cross(v, w)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def euler_to_quat(roll: float, pitch: float, yaw: float,
                  dtype=torch.float64) -> torch.Tensor:
    """ZYX Euler angles -> scalar-first quaternion (for test setups)."""
    cr, sr = math.cos(roll / 2.0), math.sin(roll / 2.0)
    cp, sp = math.cos(pitch / 2.0), math.sin(pitch / 2.0)
    cy, sy = math.cos(yaw / 2.0), math.sin(yaw / 2.0)
    return torch.tensor([cr * cp * cy + sr * sp * sy,
                         sr * cp * cy - cr * sp * sy,
                         cr * sp * cy + sr * cp * sy,
                         cr * cp * sy - sr * sp * cy], dtype=dtype)
