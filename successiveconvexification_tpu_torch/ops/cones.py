"""Symmetric-cone algebra: nonnegative orthant + second-order cones (PyTorch).

The counterpart of the JAX package's ``ops/cones.py``. A *cone vector* is a
dict of tensors; a static ``spec`` maps each key to ``"lin"`` or ``"soc"``.
For ``lin`` leaves every element is its own one-dimensional cone; for ``soc``
leaves the LAST axis is the cone dimension (scalar-first).

Batching: axis 0 of every leaf is the scenario lane. Scenario-wide
reductions (``inner``, ``max_step``) reduce over all other axes and return a
``(B,)`` tensor — the explicit form of the JAX package's per-scenario
functions under ``vmap``.

NT scaling (CVXOPT/ECOS formulas): with J = diag(1, -1, ..., -1),
    wbar = (sbar + J zbar) / (2 gamma),  eta = (s'Js / z'Jz)^(1/4),
    W^-2 = eta^-2 (2 v v' - J),  v = J wbar.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

ConeVec = Dict[str, torch.Tensor]
ConeSpec = Dict[str, str]

_BIG = 1e30


def lane(a, like: torch.Tensor):
    """Reshape a per-lane ``(B,)`` tensor to broadcast against ``like``;
    Python scalars and 0-d tensors pass through."""
    if isinstance(a, torch.Tensor) and a.dim() >= 1:
        return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))
    return a


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1)


def lane_min(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).amin(dim=1)


def lane_max(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).amax(dim=1)


def _soc_jdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u'Jv over the last axis."""
    return u[..., 0] * v[..., 0] - torch.sum(u[..., 1:] * v[..., 1:], dim=-1)


def _flip_tail(x: torch.Tensor) -> torch.Tensor:
    """J x: negate every entry but the head."""
    return torch.cat([x[..., :1], -x[..., 1:]], dim=-1)


def degree(spec: ConeSpec, x: ConeVec) -> int:
    """Barrier degree of ONE lane: #linear rows + #SOC cones."""
    deg = 0
    for k, kind in spec.items():
        shape = x[k].shape[1:]
        if kind == "lin":
            deg += math.prod(shape)
        else:
            deg += math.prod(shape[:-1]) if len(shape) > 1 else 1
    return deg


def identity(spec: ConeSpec, like: ConeVec) -> ConeVec:
    """The cone identity element e (ones for lin, (1, 0, ...) for soc)."""
    out = {}
    for k, kind in spec.items():
        a = like[k]
        if kind == "lin":
            out[k] = torch.ones_like(a)
        else:
            e = torch.zeros_like(a)
            e[..., 0] = 1.0
            out[k] = e
    return out


def inner(x: ConeVec, y: ConeVec) -> torch.Tensor:
    """Per-lane <x, y> over the entire cone vector: (B,)."""
    return sum(lane_sum(x[k] * y[k]) for k in x)


def jordan_mul(spec: ConeSpec, u: ConeVec, v: ConeVec) -> ConeVec:
    out = {}
    for k, kind in spec.items():
        if kind == "lin":
            out[k] = u[k] * v[k]
        else:
            uu, vv = u[k], v[k]
            head = torch.sum(uu * vv, dim=-1, keepdim=True)
            tail = uu[..., :1] * vv[..., 1:] + vv[..., :1] * uu[..., 1:]
            out[k] = torch.cat([head, tail], dim=-1)
    return out


def jordan_solve(spec: ConeSpec, lam: ConeVec, d: ConeVec) -> ConeVec:
    """Solve L(lam) x = d (the inverse of jordan_mul by lam)."""
    out = {}
    for k, kind in spec.items():
        if kind == "lin":
            out[k] = d[k] / lam[k]
        else:
            l0, l1 = lam[k][..., :1], lam[k][..., 1:]
            d0, d1 = d[k][..., :1], d[k][..., 1:]
            det = l0 * l0 - torch.sum(l1 * l1, dim=-1, keepdim=True)
            x0 = (l0 * d0 - torch.sum(l1 * d1, dim=-1, keepdim=True)) / det
            x1 = (d1 - x0 * l1) / l0
            out[k] = torch.cat([x0, x1], dim=-1)
    return out


def nt_scaling(spec: ConeSpec, s: ConeVec, z: ConeVec):
    """NT scaling per group: lin -> {"w"}; soc -> {"eta", "wbar"}."""
    W = {}
    for k, kind in spec.items():
        if kind == "lin":
            W[k] = {"w": torch.sqrt(s[k] / z[k])}
        else:
            ss, zz = s[k], z[k]
            res_s = _soc_jdot(ss, ss)
            res_z = _soc_jdot(zz, zz)
            sbar = ss / torch.sqrt(res_s)[..., None]
            zbar = zz / torch.sqrt(res_z)[..., None]
            eucl = torch.sum(sbar * zbar, dim=-1)
            gamma = torch.sqrt((1.0 + eucl) / 2.0)
            wbar = (sbar + _flip_tail(zbar)) / (2.0 * gamma[..., None])
            eta = (res_s / res_z) ** 0.25
            W[k] = {"eta": eta, "wbar": wbar}
    return W


def _soc_w_apply(eta, wbar, v, inverse: bool):
    a = wbar[..., :1]
    b = wbar[..., 1:]
    bs = -b if inverse else b
    v0, v1 = v[..., :1], v[..., 1:]
    top = a * v0 + torch.sum(bs * v1, dim=-1, keepdim=True)
    bot = bs * v0 + v1 + b * (torch.sum(b * v1, dim=-1, keepdim=True)) / (1.0 + a)
    scale = (1.0 / eta if inverse else eta)[..., None]
    return torch.cat([top, bot], dim=-1) * scale


def w_apply(spec: ConeSpec, W, v: ConeVec, inverse: bool = False) -> ConeVec:
    out = {}
    for k, kind in spec.items():
        if kind == "lin":
            w = W[k]["w"]
            out[k] = v[k] / w if inverse else v[k] * w
        else:
            out[k] = _soc_w_apply(W[k]["eta"], W[k]["wbar"], v[k], inverse)
    return out


def scaling_point(spec: ConeSpec, W, z: ConeVec) -> ConeVec:
    """lambda = W z (== W^{-1} s by the NT property)."""
    return w_apply(spec, W, z, inverse=False)


def _lin_max_step(s, ds):
    neg = ds < 0
    alpha = torch.where(neg, -s / torch.where(neg, ds, -torch.ones_like(ds)),
                        torch.full_like(s, _BIG))
    if alpha[0].numel() == 0:
        return torch.full(s.shape[:1], _BIG, dtype=s.dtype, device=s.device)
    return lane_min(alpha)


def _soc_max_step(s, ds):
    """Largest alpha with s + alpha ds in SOC, per lane."""
    c = _soc_jdot(s, s)
    b = _soc_jdot(s, ds)
    a = _soc_jdot(ds, ds)
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    big = torch.full_like(a, _BIG)
    quad = torch.abs(a) > 1e-14
    a_safe = torch.where(quad, a, torch.ones_like(a))
    r1 = (-b - sq) / a_safe
    r2 = (-b + sq) / a_safe
    valid_quad = quad & (disc >= 0)
    r1 = torch.where(valid_quad & (r1 > 0), r1, big)
    r2 = torch.where(valid_quad & (r2 > 0), r2, big)
    b_safe = torch.where(b < 0, b, -torch.ones_like(b))
    r_lin = torch.where(~quad & (b < 0), -c / (2.0 * b_safe), big)
    alpha_quad = torch.minimum(torch.minimum(r1, r2), r_lin)
    s0, d0 = s[..., 0], ds[..., 0]
    alpha_head = torch.where(d0 < 0, -s0 / torch.where(d0 < 0, d0, -torch.ones_like(d0)),
                             big)
    alpha = torch.minimum(alpha_quad, alpha_head)
    if alpha[0].numel() == 0:
        return torch.full(s.shape[:1], _BIG, dtype=s.dtype, device=s.device)
    return lane_min(alpha)


def max_step(spec: ConeSpec, s: ConeVec, ds: ConeVec) -> torch.Tensor:
    """Per-lane max alpha >= 0 with s + alpha ds in the cone (capped at 1e30)."""
    alphas = [_lin_max_step(s[k], ds[k]) if kind == "lin"
              else _soc_max_step(s[k], ds[k]) for k, kind in spec.items()]
    return torch.stack(alphas, dim=0).amin(dim=0)


def winv2_terms(spec: ConeSpec, W):
    """lin: {"d": w^-2}; soc: {"coef": eta^-2, "v": J wbar}."""
    out = {}
    for k, kind in spec.items():
        if kind == "lin":
            out[k] = {"d": W[k]["w"] ** -2}
        else:
            out[k] = {"coef": W[k]["eta"] ** -2, "v": _flip_tail(W[k]["wbar"])}
    return out


def winv2_apply(spec: ConeSpec, W, x: ConeVec) -> ConeVec:
    """W^-2 x per group."""
    out = {}
    for k, kind in spec.items():
        if kind == "lin":
            out[k] = x[k] * W[k]["w"] ** -2
        else:
            v = _flip_tail(W[k]["wbar"])
            coef = (W[k]["eta"] ** -2)[..., None]
            vx = torch.sum(v * x[k], dim=-1, keepdim=True)
            out[k] = coef * (2.0 * v * vx - _flip_tail(x[k]))
    return out


def tree_add(x: ConeVec, y: ConeVec, alpha=1.0) -> ConeVec:
    """x + alpha y, with alpha a scalar or a per-lane (B,) tensor."""
    return {k: x[k] + lane(alpha, x[k]) * y[k] for k in x}


def tree_scale(x: ConeVec, alpha) -> ConeVec:
    return {k: x[k] * lane(alpha, x[k]) for k in x}
