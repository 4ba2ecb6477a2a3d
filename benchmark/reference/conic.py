"""A plain primal-dual interior-point method for batches of dense
second-order cone programs:

    minimize x'Px / 2 + c'x  subject to  A x = b,  G x + s = h,  s in C,

C a product of a nonnegative orthant (the first ``lp`` rows of G) and
second-order cones {(t, v): t >= |v|}, grouped by dimension. Every lane of
the batch has the same layout and its own numbers.

The method is the textbook one (Vandenberghe, "The CVXOPT linear and
quadratic cone program solvers", 2010, sections 3-4): Nesterov-Todd
scaling, Mehrotra's predictor-corrector, the Newton system reduced to
(P + G' W^-2 G) dx + A' dy = r and solved by Cholesky factors and the Schur
complement of A. It imports torch alone and nothing of the program.

``Arith`` says in which precision it computes: float64, or float32 with
every matrix product's inputs rounded to TF32's 10 mantissa bits (the
benchmark's lower-precision control).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10 explicit mantissa bits (to
    nearest); other dtypes as they are."""
    if t.dtype != torch.float32:
        return t
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32).reshape(t.shape)


@dataclass(frozen=True)
class Arith:
    """The precision of a solve: ``"float64"`` or ``"tf32"``."""
    name: str = "float64"

    @property
    def dtype(self):
        return torch.float64 if self.name == "float64" else torch.float32

    def mm(self, a, b):
        if self.name == "tf32":
            return tf32(a) @ tf32(b)
        return a @ b


@dataclass(frozen=True)
class Cones:
    """``lp`` orthant rows, then ``socs``: (count, dim) groups of cones."""
    lp: int
    socs: tuple

    @property
    def rows(self) -> int:
        return self.lp + sum(n * d for n, d in self.socs)

    @property
    def degree(self) -> int:
        return self.lp + sum(n for n, _ in self.socs)

    def split(self, v):
        """(L, rows, ...) -> [lp part (L, lp, ...), (L, n, d, ...) each]."""
        tail = v.shape[2:]
        parts, at = [v[:, :self.lp]], self.lp
        for n, d in self.socs:
            parts.append(v[:, at:at + n * d].reshape(
                (v.shape[0], n, d) + tail))
            at += n * d
        return parts

    def join(self, parts):
        L = parts[0].shape[0]
        tail = parts[0].shape[2:]
        return torch.cat([parts[0]] + [p.reshape((L, -1) + tail)
                                       for p in parts[1:]], 1)

    def identity(self, L, dtype, device):
        parts = [torch.ones((L, self.lp), dtype=dtype, device=device)]
        for n, d in self.socs:
            e = torch.zeros((L, n, d), dtype=dtype, device=device)
            e[..., 0] = 1.0
            parts.append(e)
        return self.join(parts)


def _soc_det(x):
    return x[..., 0] ** 2 - (x[..., 1:] ** 2).sum(-1)


def min_eig(cones: Cones, v):
    """The smallest 'eigenvalue' of v in each lane (v in int C iff > 0)."""
    parts = cones.split(v)
    out = parts[0].amin(1) if cones.lp else None
    for p in parts[1:]:
        e = (p[..., 0] - p[..., 1:].norm(dim=-1)).amin(1)
        out = e if out is None else torch.minimum(out, e)
    return out


class Scaling:
    """The Nesterov-Todd scaling W of (s, z) in int C: W z = W^-1 s =
    lambda. On a cone, W = beta * What with
    What = [[w0, w1'], [w1, I + w1 w1' / (1 + w0)]] and w'Jw = 1."""

    def __init__(self, cones: Cones, s, z):
        self.cones = cones
        sp, zp = cones.split(s), cones.split(z)
        self.lp_w = torch.sqrt(sp[0] / zp[0])
        self.soc = []
        for ps, pz in zip(sp[1:], zp[1:]):
            sn = torch.sqrt(_soc_det(ps))
            zn = torch.sqrt(_soc_det(pz))
            sb, zb = ps / sn[..., None], pz / zn[..., None]
            gamma = torch.sqrt((1.0 + (sb * zb).sum(-1)) / 2.0)
            jz = torch.cat([zb[..., :1], -zb[..., 1:]], -1)
            w = (sb + jz) / (2.0 * gamma[..., None])
            self.soc.append((torch.sqrt(sn / zn), w))
        self.lam = self.apply(z)

    def apply(self, v, inverse: bool = False):
        """W v (or W^-1 v) for v of shape (L, rows) or (L, rows, n)."""
        parts = self.cones.split(v)
        out = [parts[0] / _pad(self.lp_w, parts[0]) if inverse
               else parts[0] * _pad(self.lp_w, parts[0])]
        for (beta, w), p in zip(self.soc, parts[1:]):
            w, beta = _pad(w, p), _pad(beta, p)
            w0, w1 = w[:, :, :1], w[:, :, 1:]
            p0, p1 = p[:, :, :1], p[:, :, 1:]
            w1p1 = (w1 * p1).sum(2, keepdim=True)
            sign = -1.0 if inverse else 1.0
            o0 = w0 * p0 + sign * w1p1
            o1 = p1 + (sign * p0 + w1p1 / (1.0 + w0)) * w1
            o = torch.cat([o0, o1], 2)
            out.append(o / beta if inverse else o * beta)
        return self.cones.join(out)


class Factor:
    """H = P + Gh'Gh factored for solves, where the last ``nd`` variables
    appear only in orthant rows of their own (slacks), so that their block
    of H is diagonal: H is factored through the Schur complement of that
    block, a Cholesky factor of the first block's size."""

    def __init__(self, P, Gh, nd: int, mm, reg: float):
        na = Gh.shape[2] - nd
        self.na = na
        Ga, Gd = Gh[..., :na], Gh[..., na:]
        Haa = P[:, :na, :na] + mm(Ga.transpose(1, 2), Ga)
        self.Had = P[:, :na, na:] + mm(Ga.transpose(1, 2), Gd)
        D = (Gd * Gd).sum(1) + P.diagonal(dim1=1, dim2=2)[:, na:]
        top = torch.cat([Haa.diagonal(dim1=1, dim2=2), D], 1).amax(1)
        self.D = D + reg * top[:, None]
        S = Haa - mm(self.Had / self.D[:, None, :], self.Had.transpose(1, 2))
        S = S + reg * top[:, None, None] * torch.eye(na, dtype=S.dtype,
                                                      device=S.device)
        self.L, self.info = torch.linalg.cholesky_ex(S)
        self.mm = mm

    def solve(self, v):
        """H^-1 v for v of shape (L, n) or (L, n, k)."""
        vec = v.dim() == 2
        if vec:
            v = v[..., None]
        va, vd = v[:, :self.na], v[:, self.na:] / self.D[..., None]
        xa = torch.cholesky_solve(va - self.mm(self.Had, vd), self.L)
        xd = vd - self.mm(self.Had.transpose(1, 2), xa) / self.D[..., None]
        x = torch.cat([xa, xd], 1)
        return x[..., 0] if vec else x


def _pad(t, like):
    """t (L, n[, d]) with trailing axes added to broadcast against like."""
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def _inf_norm(t):
    """The largest |entry| of each lane of (L, n); 0 where n is 0."""
    if t.shape[1] == 0:
        return torch.zeros(t.shape[:1], dtype=t.dtype, device=t.device)
    return t.abs().amax(1)


def jordan(cones: Cones, x, y):
    """The cone's product x o y."""
    px, py = cones.split(x), cones.split(y)
    out = [px[0] * py[0]]
    for a, b in zip(px[1:], py[1:]):
        out.append(torch.cat([(a * b).sum(-1, keepdim=True),
                              a[..., :1] * b[..., 1:] + b[..., :1] * a[..., 1:]],
                             -1))
    return cones.join(out)


def jordan_div(cones: Cones, lam, d):
    """u with lam o u = d."""
    pl, pd = cones.split(lam), cones.split(d)
    out = [pd[0] / pl[0]]
    for a, b in zip(pl[1:], pd[1:]):
        a0, a1, b0, b1 = a[..., :1], a[..., 1:], b[..., :1], b[..., 1:]
        u0 = (a0 * b0 - (a1 * b1).sum(-1, keepdim=True)) / _soc_det(a)[..., None]
        out.append(torch.cat([u0, (b1 - u0 * a1) / a0], -1))
    return cones.join(out)


def max_step(cones: Cones, x, d):
    """The largest alpha >= 0 with x + alpha d in C, per lane (inf if none
    bounds it); x in int C."""
    px, pd = cones.split(x), cones.split(d)
    inf = torch.full(x.shape[:1], float("inf"), dtype=x.dtype, device=x.device)
    out = inf
    if cones.lp:
        r = torch.where(pd[0] < 0, -px[0] / pd[0], torch.full_like(px[0], float("inf")))
        out = torch.minimum(out, r.amin(1))
    for a, b in zip(px[1:], pd[1:]):
        c = _soc_det(a)
        bb = 2.0 * (a[..., 0] * b[..., 0] - (a[..., 1:] * b[..., 1:]).sum(-1))
        aa = _soc_det(b)
        disc = bb * bb - 4.0 * aa * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        q = -0.5 * (bb + torch.where(bb >= 0, sq, -sq))
        big = torch.full_like(c, float("inf"))
        r1 = torch.where(aa != 0, q / torch.where(aa != 0, aa, 1.0), big)
        r2 = torch.where(q != 0, c / torch.where(q != 0, q, 1.0), big)
        r1 = torch.where(r1 > 0, r1, big)
        r2 = torch.where(r2 > 0, r2, big)
        r = torch.where(disc >= 0, torch.minimum(r1, r2), big)
        # a linear det (aa == 0): the one root -c / bb where bb < 0
        lin = torch.where(bb < 0, -c / torch.where(bb < 0, bb, -1.0), big)
        r = torch.where(aa == 0, lin, r)
        out = torch.minimum(out, r.amin(1))
    return out


def solve(P, c, A, b, G, h, cones: Cones, x0, arith: Arith = Arith(),
          tol: float = 1e-9, max_iters: int = 60, slacks: int = 0):
    """Solve each lane's program from the primal point ``x0``; returns
    (x, y, z, s, converged), P positive semidefinite, with converged per
    lane: the primal residuals
    and the gap under ``tol`` and the dual residual under 1e3 ``tol``
    (the reduced system's factor limits its accuracy as W grows
    ill-conditioned). The last ``slacks`` variables must appear in orthant
    rows of their own only (``Factor``). A lane whose iterate stops being
    a number keeps its last finite one."""
    L, n = c.shape
    dt = arith.dtype
    P, c, A, b, G, h, x = (t.to(dt) for t in (P, c, A, b, G, h, x0))
    dev = c.device
    m = cones.rows
    e = cones.identity(L, dt, dev)
    mv = arith.mm

    def mat(M, v):
        return mv(M, v[..., None])[..., 0]

    def tmat(M, v):
        return mv(M.transpose(1, 2), v[..., None])[..., 0]

    # the objective scaled to entries of at most 1 (x does not change);
    # z from the least-squares dual start of the CVXOPT notes (W = I),
    # s from x0; both shifted into the cone's interior
    scale = torch.clamp(_inf_norm(c), min=1.0)
    c, P = c / scale[:, None], P / scale[:, None, None]
    F = Factor(P, G, slacks, mv, 1e-10)
    HiAt = F.solve(A.transpose(1, 2))
    Ls, _ = torch.linalg.cholesky_ex(mv(A, HiAt))
    Hic = F.solve(-c)
    y = torch.cholesky_solve(mat(A, Hic)[..., None], Ls)[..., 0]
    z = mat(G, Hic - mat(HiAt, y))
    s = h - mat(G, x)
    s = s + torch.clamp(1.0 - min_eig(cones, s), min=0.0)[:, None] * e
    z = z + torch.clamp(1.0 - min_eig(cones, z), min=0.0)[:, None] * e
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    scale_b, scale_h, scale_c = (1.0 + _inf_norm(t) for t in (b, h, c))
    for _ in range(max_iters):
        Px = mat(P, x)
        rx = Px + c + tmat(A, y) + tmat(G, z)
        ry = mat(A, x) - b
        rz = mat(G, x) + s - h
        mu = (s * z).sum(1) / cones.degree
        pobj = ((0.5 * Px + c) * x).sum(1)
        ok = ((_inf_norm(rx) / scale_c < 1e3 * tol)
              & (_inf_norm(ry) / scale_b < tol)
              & (_inf_norm(rz) / scale_h < tol)
              & (mu * cones.degree < tol * (1.0 + pobj.abs())))
        done = done | ok
        if bool(done.all()):
            break
        W = Scaling(cones, s, z)
        lam = W.lam
        Gh = W.apply(G, inverse=True)
        F = Factor(P, Gh, slacks, mv, 1e-13 if dt == torch.float64 else 1e-7)
        info = F.info
        HiAt = F.solve(A.transpose(1, 2))
        S = mv(A, HiAt)
        Ls, info2 = torch.linalg.cholesky_ex(S)

        def newton(ds_target):
            u = jordan_div(cones, lam, ds_target)
            rzh = W.apply(-rz, inverse=True)
            r1 = -rx + tmat(Gh, rzh - u)
            Hir1 = F.solve(r1)
            dy = torch.cholesky_solve((mat(A, Hir1) + ry)[..., None], Ls)[..., 0]
            dx = Hir1 - mat(HiAt, dy)
            Wdz = mat(Gh, dx) + u - rzh
            Wids = rzh - mat(Gh, dx)
            return dx, dy, W.apply(Wdz, inverse=True), W.apply(Wids), Wdz, Wids

        ll = jordan(cones, lam, lam)
        dx, dy, dz, ds, Wdz, Wids = newton(-ll)
        a_aff = torch.minimum(max_step(cones, s, ds), max_step(cones, z, dz))
        a_aff = torch.clamp(a_aff, max=1.0)
        sig = (1.0 - a_aff) ** 3
        target = -ll - jordan(cones, Wids, Wdz) + (sig * mu)[:, None] * e
        dx, dy, dz, ds, _, _ = newton(target)
        alpha = torch.minimum(max_step(cones, s, ds), max_step(cones, z, dz))
        alpha = torch.clamp(0.99 * alpha, max=1.0)
        alpha = torch.where(done | (info != 0) | (info2 != 0),
                            torch.zeros_like(alpha), alpha)
        nx_, ny_, nz_, ns_ = (x + alpha[:, None] * dx, y + alpha[:, None] * dy,
                              z + alpha[:, None] * dz, s + alpha[:, None] * ds)
        fin = (torch.isfinite(nx_).all(1) & torch.isfinite(ny_).all(1)
               & torch.isfinite(nz_).all(1) & torch.isfinite(ns_).all(1))
        keep = fin[:, None]
        x = torch.where(keep, nx_, x)
        y = torch.where(keep, ny_, y)
        z = torch.where(keep, nz_, z)
        s = torch.where(keep, ns_, s)
    return x, y * scale[:, None], z * scale[:, None], s, done
