"""The plain reference's own solve of a batch of scenarios: successive
convexification (Mao, Szmuk and Acikmese, "Successive convexification of
non-convex optimal control problems and its convergence properties", CDC
2016) over the multiple-shooting transcription that ``judge.py`` checks.

Each iteration linearizes the RK4 flow of every interval about the current
trajectory (``torch.func.jacfwd`` through ``judge.propagate``'s arithmetic),
and solves the convex subproblem with ``conic.solve``:

    minimize   obj(x, u, sigma) + w_nu (|nu|_1 + sum_k s_k)
               + (the dynamics' Lagrangian Hessian, made convex interval
                  by interval, on the step) / 2
    subject to x_{k+1} = linearized flow + nu_k,  the pinned boundary values,
               the model's convex path constraints (``<model>.cones``),
               u_k'ubar_k / |ubar_k| + s_k >= T_min, s >= 0,
               sigma within the configuration's bounds (free final time),
               |(x_k, u_k) - (xbar_k, ubar_k)|_2 <= eta at each node,
               |sigma - sigmabar| <= tr_sigma_frac sigmabar min(eta, 1).

Where the merit fell by less than half the predicted fall, the subproblem
is solved again with the flow's second-order remainder at the step taken
out of the dynamics rows (a second-order correction), and the better of
the two steps by the nonlinear merit obj + w_nu (|defect|_1
+ thrust shortfall) is taken where the merit falls at all; eta
shrinks or grows with the share of the predicted fall that came. A lane is done when the predicted
fall is below ``tol`` with the trust region not reached (a stationary
point), or eta below the configuration's tr_min.

``obj`` and ``w_nu`` are the configuration's (obj = w_sigma sigma - w_mass
m_K); the trust region's first, least and largest radius and the share
of sigma it allows are too. Everything
here is plain PyTorch and independent of the program under test; it starts
from each scenario's own straight-line guess and takes nothing from the
program.
"""

from __future__ import annotations

import torch

from reference import conic
from reference import judge as J



def _flow(m, substeps: int, foh: bool, h: float):
    """The end states of every interval of a batch, and their Jacobians in
    (x_k, u_k, u_k+1, sigma): RK4 as ``judge.propagate`` without the
    retraction (the subproblem is linear in the raw state)."""

    def f(x, uk, uk1, sig, p):
        pp = {k: v[None] for k, v in p.items()}
        dt = h / substeps

        def xdot(tau, xx):
            lam = tau / h if foh else 0.0
            u = (1.0 - lam) * uk + lam * uk1
            return sig * m.dynamics(pp, xx[None, None], u[None, None])[0, 0]

        for i in range(substeps):
            tau = i * dt
            k1 = xdot(tau, x)
            k2 = xdot(tau + dt / 2, x + dt / 2 * k1)
            k3 = xdot(tau + dt / 2, x + dt / 2 * k2)
            k4 = xdot(tau + dt, x + dt * k3)
            x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        return x, x

    def batched(g):
        per_interval = torch.func.vmap(g, in_dims=(0, 0, 0, None, None))
        return torch.func.vmap(per_interval, in_dims=(0, 0, 0, 0, 0))

    def weighted(w, p, y):
        """y'flow as a function of w = (x_k, u_k, u_k+1, sigma)."""
        nx, nu = m.NX, m.NU
        x, uk, uk1 = w[:nx], w[nx:nx + nu], w[nx + nu:nx + 2 * nu]
        return (y * f(x, uk, uk1, w[-1], p)[0]).sum()

    ends = batched(lambda *a: f(*a)[0])
    jac = batched(torch.func.jacfwd(f, argnums=(0, 1, 2, 3), has_aux=True))
    hess = torch.func.vmap(torch.func.vmap(torch.func.hessian(weighted),
                                           in_dims=(0, None, 0)),
                           in_dims=(0, 0, 0))
    return ends, jac, hess


class Problem:
    """The index layout of the subproblem of one configuration."""

    def __init__(self, config: dict, m):
        s = config["solver"]
        self.m = m
        self.K = K = s["disc"]["K"]
        self.nx, self.nu = nx, nu = m.NX, m.NU
        self.free = bool(s["free_final_time"])
        sc = s["scvx"]
        self.w_sigma, self.w_mass = sc["w_sigma"], sc["w_mass"]
        self.sig_frac = (sc["sigma_min_frac"], sc["sigma_max_frac"])
        self.tr_sigma_frac = sc["tr_sigma_frac"]
        self.tr = (sc["tr_init"], sc["tr_min"], sc["tr_max"])
        self.w = sc["w_nu"]
        self.N = N = K - 1
        self.iU = K * nx
        self.iS = K * (nx + nu)
        self.nz = self.iS + (1 if self.free else 0)     # (x, u, sigma)
        self.iP = self.nz                   # virtual controls nu = nu+ - nu-
        self.iM = self.iP + N * nx
        self.iT = self.iM + N * nx          # thrust shortfall slacks
        self.n = self.iT + K
        self.ends, self.jac, self.hess = _flow(
            m, s["disc"]["substeps"], s["disc"]["foh"], 1.0 / (K - 1))

    def pack(self, X, U, sigma):
        z = [X.flatten(1), U.flatten(1)]
        if self.free:
            z.append(sigma[:, None])
        return torch.cat(z, 1)

    def unpack(self, z, sigma_fixed):
        L = z.shape[0]
        X = z[:, :self.iU].reshape(L, self.K, self.nx)
        U = z[:, self.iU:self.iS].reshape(L, self.K, self.nu)
        sigma = z[:, self.iS] if self.free else sigma_fixed
        return X, U, sigma

    def objective(self, X, sigma):
        return self.w_sigma * sigma - self.w_mass * X[:, -1, 0]

    def merit(self, p, X, U, sigma):
        """(merit, defect (L1), thrust shortfall) of trajectories."""
        ends = self.ends(X[:, :-1], U[:, :-1], U[:, 1:], sigma, p)
        defect = (X[:, 1:] - ends).abs().sum((1, 2))
        short = torch.clamp(p["T_min"][:, None] - U.norm(dim=-1), min=0.0).sum(1)
        return (self.objective(X, sigma) + self.w * (defect + short),
                defect, short)

    def hessian(self, p, X, U, sigma, y_dyn):
        """The Hessian of the Lagrangian in (x, u, sigma), - sum_k y_k'
        d2 flow_k (y the dynamics rows' multipliers), each interval's block
        with its negative eigenvalues set to 0, in an (L, n, n) matrix."""
        L, N, nx, nu = X.shape[0], self.N, self.nx, self.nu
        dev = X.device
        w = torch.cat([X[:, :-1], U[:, :-1], U[:, 1:],
                       sigma[:, None, None].expand(L, N, 1)], -1)
        Hk = -self.hess(w, p, y_dyn)                      # (L, N, 21, 21)
        ar = torch.arange(N, device=dev)
        cols = torch.cat([ar[:, None] * nx + torch.arange(nx, device=dev),
                          self.iU + ar[:, None] * nu + torch.arange(nu, device=dev),
                          self.iU + (ar[:, None] + 1) * nu + torch.arange(nu, device=dev),
                          torch.full((N, 1), self.iS, device=dev)], 1)
        if not self.free:
            cols, Hk = cols[:, :-1], Hk[..., :-1, :-1]
        # the clamp in float64 whatever the arithmetic: float32's eigh does
        # not converge on every block of the lower-precision control
        Hk = torch.nan_to_num(0.5 * (Hk + Hk.transpose(-1, -2)).double(),
                              nan=0.0, posinf=0.0, neginf=0.0)
        ev, V = torch.linalg.eigh(Hk)
        Hk = ((V * torch.clamp(ev, min=0.0)[..., None, :])
              @ V.transpose(-1, -2)).to(X.dtype)
        P = torch.zeros((L, self.n, self.n), dtype=X.dtype, device=dev)
        d = cols.shape[1]
        li = torch.arange(L, device=dev)[:, None, None, None].expand(L, N, d, d)
        ri = cols[None, :, :, None].expand(L, N, d, d)
        ci = cols[None, :, None, :].expand(L, N, d, d)
        P.index_put_((li, ri, ci), Hk, accumulate=True)
        return P

    def subproblem(self, p, X, U, sigma, eta):
        """(c, A, b, G, h, cones, z0) of the convex subproblem about
        (X, U, sigma)."""
        L, K, N, nx, nu, n = X.shape[0], self.K, self.N, self.nx, self.nu, self.n
        dt, dev = X.dtype, X.device
        (Ax, Bm, Bp, S), ends = self.jac(X[:, :-1], U[:, :-1], U[:, 1:],
                                         sigma, p)
        ar = torch.arange(N, device=dev)
        ii = torch.arange(nx, device=dev)
        jj = torch.arange(nu, device=dev)

        # dynamics: x_k+1 - A x_k - Bm u_k - Bp u_k+1 - S sigma - nu+ + nu- = b
        Ad = torch.zeros((L, N, nx, n), dtype=dt, device=dev)
        k3, i3 = ar[:, None, None], ii[None, :, None]
        Ad[:, ar[:, None], ii[None, :], (ar[:, None] + 1) * nx + ii[None, :]] = 1.0
        Ad[:, k3, i3, ar[:, None, None] * nx + ii[None, None, :]] = -Ax
        Ad[:, k3, i3, self.iU + ar[:, None, None] * nu + jj[None, None, :]] = -Bm
        Ad[:, k3, i3, self.iU + (ar[:, None, None] + 1) * nu + jj[None, None, :]] = -Bp
        Ad[:, ar[:, None], ii[None, :], self.iP + ar[:, None] * nx + ii[None, :]] = -1.0
        Ad[:, ar[:, None], ii[None, :], self.iM + ar[:, None] * nx + ii[None, :]] = 1.0
        bd = (ends - (Ax @ X[:, :-1, :, None])[..., 0]
              - (Bm @ U[:, :-1, :, None])[..., 0]
              - (Bp @ U[:, 1:, :, None])[..., 0])
        if self.free:
            Ad[:, :, :, self.iS] = -S
            bd = bd - S * sigma[:, None, None]
        first, last = self.m.pins(p)
        fi = torch.tensor(self.m.FIRST, device=dev)
        la = torch.tensor(self.m.LAST, device=dev)
        Ab = torch.zeros((L, len(fi) + len(la), n), dtype=dt, device=dev)
        Ab[:, torch.arange(len(fi), device=dev), fi] = 1.0
        Ab[:, len(fi) + torch.arange(len(la), device=dev), (K - 1) * nx + la] = 1.0
        A = torch.cat([Ad.reshape(L, N * nx, n), Ab], 1)
        b = torch.cat([bd.reshape(L, N * nx), first, last], 1)

        # cones: s = h - G z
        lp_G, lp_h, soc = [], [], []

        def node_rows(dim, M, a, at_last):
            nodes = K if at_last else K - 1
            kk = torch.arange(nodes, device=dev)
            cols = torch.cat([kk[:, None] * nx + ii[None, :],
                              self.iU + kk[:, None] * nu + jj[None, :]], 1)
            Gb = torch.zeros((L, nodes, dim, n), dtype=dt, device=dev)
            Gb[:, kk[:, None, None], torch.arange(dim, device=dev)[None, :, None],
               cols[:, None, :]] = -M[:, None].expand(L, nodes, dim, nx + nu)
            return Gb, a[:, None].expand(L, nodes, dim)

        for dim, M, a, at_last in self.m.cones(p):
            Gb, hb = node_rows(dim, M, a, at_last)
            if dim == 1:
                lp_G.append(Gb.reshape(L, -1, n))
                lp_h.append(hb.reshape(L, -1))
            else:
                soc.append((Gb, hb))
        # thrust's lower bound, linearized: ghat'u_k + s_k - T_min >= 0
        kk = torch.arange(K, device=dev)
        ghat = U / U.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        Gt = torch.zeros((L, K, n), dtype=dt, device=dev)
        Gt[:, kk[:, None], self.iU + kk[:, None] * nu + jj[None, :]] = -ghat
        Gt[:, kk, self.iT + kk] = -1.0
        lp_G.append(Gt)
        lp_h.append(-p["T_min"][:, None].expand(L, K))
        # nu+, nu-, s >= 0
        nslack = self.n - self.iP
        Gs = torch.zeros((L, nslack, n), dtype=dt, device=dev)
        Gs[:, torch.arange(nslack, device=dev), self.iP + torch.arange(nslack, device=dev)] = -1.0
        lp_G.append(Gs)
        lp_h.append(torch.zeros((L, nslack), dtype=dt, device=dev))
        if self.free:
            lo, hi = self.sig_frac
            Gsig = torch.zeros((L, 2, n), dtype=dt, device=dev)
            Gsig[:, 0, self.iS] = -1.0
            Gsig[:, 1, self.iS] = 1.0
            lp_G.append(Gsig)
            lp_h.append(torch.stack([-lo * p["tf_guess"], hi * p["tf_guess"]], 1))
        # trust region: (eta, x_k - xbar_k, u_k - ubar_k) in a cone at each
        # node; sigma within tr_sigma_frac sigmabar min(eta, 1) of sigmabar
        if self.free:
            r = self.tr_sigma_frac * sigma * torch.clamp(eta, max=1.0)
            Gsr = torch.zeros((L, 2, n), dtype=dt, device=dev)
            Gsr[:, 0, self.iS] = 1.0
            Gsr[:, 1, self.iS] = -1.0
            lp_G.append(Gsr)
            lp_h.append(torch.stack([sigma + r, r - sigma], 1))
        cols = torch.cat([kk[:, None] * nx + ii[None, :],
                          self.iU + kk[:, None] * nu + jj[None, :]], 1)
        Gtr = torch.zeros((L, K, 1 + nx + nu, n), dtype=dt, device=dev)
        Gtr[:, kk[:, None], 1 + torch.arange(nx + nu, device=dev)[None, :], cols] = -1.0
        htr = torch.cat([eta[:, None, None].expand(L, K, 1),
                         -torch.cat([X, U], -1)], -1)
        soc.append((Gtr, htr))
        G = torch.cat(lp_G + [g.reshape(L, -1, n) for g, _ in soc], 1)
        h = torch.cat(lp_h + [hh.reshape(L, -1) for _, hh in soc], 1)
        cones = conic.Cones(lp=sum(g.shape[1] for g in lp_G),
                            socs=tuple((g.shape[1], g.shape[2]) for g, _ in soc))

        c = torch.zeros((L, n), dtype=dt, device=dev)
        if self.free:
            c[:, self.iS] = self.w_sigma
        c[:, (K - 1) * nx] -= self.w_mass
        c[:, self.iP:] = self.w

        d = (X[:, 1:] - ends).flatten(1)
        short = torch.clamp(p["T_min"][:, None] - (ghat * U).sum(-1), min=0.0)
        z0 = torch.cat([self.pack(X, U, sigma), torch.clamp(d, min=0.0),
                        torch.clamp(-d, min=0.0), short], 1)
        return c, A, b, G, h, cones, z0


def solve(config: dict, params: dict, arith: conic.Arith = conic.Arith(),
          max_iters: int = 80, tol: float = 1e-9):
    """Solve each scenario of ``params`` (field -> (L, ...) tensor) from its
    straight-line guess; returns a dict of X (L, K, nx), U, sigma in the
    arithmetic's dtype, and per lane the objective, the merit, the
    iterations and whether it reached a stationary point."""
    m = J.model(config["model"])
    prob = Problem(config, m)
    dt = arith.dtype
    p = {k: v.to(dt) for k, v in params.items()}
    X, U, sigma = m.initial_guess(p, prob.K)
    L = X.shape[0]
    ipm_tol = 1e-9 if dt == torch.float64 else 1e-5
    merit, _, _ = prob.merit(p, X, U, sigma)
    eta = torch.full((L,), prob.tr[0], dtype=dt, device=X.device)
    done = torch.zeros(L, dtype=torch.bool, device=X.device)
    stationary = torch.zeros_like(done)
    iters = torch.zeros(L, dtype=torch.int64, device=X.device)
    y_dyn = torch.zeros((L, prob.N, prob.nx), dtype=dt, device=X.device)
    for _ in range(max_iters):
        Pm = prob.hessian(p, X, U, sigma, y_dyn)
        c, A, b, G, h, cones, z0 = prob.subproblem(p, X, U, sigma, eta)
        zbar = z0[:, :prob.nz]
        cq = c.clone()
        cq[:, :prob.nz] -= (Pm[:, :prob.nz, :prob.nz] @ zbar[..., None])[..., 0]
        z, y, _, _, solved = conic.solve(Pm, cq, A, b, G, h, cones, z0,
                                         arith=arith, tol=ipm_tol,
                                         slacks=prob.n - prob.iP)
        Xn, Un, sn = prob.unpack(z, sigma)
        dz = z[:, :prob.nz] - zbar
        quad = 0.5 * (dz * (Pm[:, :prob.nz, :prob.nz] @ dz[..., None])[..., 0]).sum(1)
        nu = z[:, prob.iP:prob.iM] - z[:, prob.iM:prob.iT]
        lin = (c * z).sum(1) + quad + (0.0 if prob.free else prob.w_sigma * sigma)
        mn, _, _ = prob.merit(p, Xn, Un, sn)
        pred = merit - lin
        # second-order correction where the step did poorly: the same
        # subproblem with the flow's remainder at the step taken out of
        # the dynamics rows
        poor = ~done & ((merit - mn) < 0.5 * pred)
        if bool(poor.any()):
            nu = nu.reshape(L, prob.N, prob.nx)
            rem = Xn[:, 1:] - prob.ends(Xn[:, :-1], Un[:, :-1], Un[:, 1:], sn, p) - nu
            b2 = b.clone()
            b2[:, :prob.N * prob.nx] -= rem.flatten(1)
            z2, y2, _, _, _ = conic.solve(Pm, cq, A, b2, G, h, cones, z,
                                          arith=arith, tol=ipm_tol,
                                          slacks=prob.n - prob.iP)
            X2, U2, s2 = prob.unpack(z2, sigma)
            m2, _, _ = prob.merit(p, X2, U2, s2)
            better = poor & torch.isfinite(m2) & torch.isfinite(z2).all(1) & (m2 < mn)
            Xn = torch.where(better[:, None, None], X2, Xn)
            Un = torch.where(better[:, None, None], U2, Un)
            sn = torch.where(better, s2, sn)
            mn = torch.where(better, m2, mn)
            y = torch.where(better[:, None], y2, y)
            z = torch.where(better[:, None], z2, z)
        rho = (merit - mn) / torch.where(pred > 0, pred, 1.0)
        fin = torch.isfinite(mn) & torch.isfinite(z).all(1)
        step = (torch.cat([Xn - X, Un - U], -1)).norm(dim=-1).amax(1)
        small = solved & (pred <= tol * (1.0 + merit.abs())) & (step < 0.5 * eta)
        accept = ~done & ~small & fin & (rho > 0.0)
        X = torch.where(accept[:, None, None], Xn, X)
        U = torch.where(accept[:, None, None], Un, U)
        sigma = torch.where(accept, sn, sigma)
        merit = torch.where(accept, mn, merit)
        iters = iters + (~done).long()
        upd = (~done & fin)[:, None]
        y_dyn = torch.where(upd[..., None], y[:, :prob.N * prob.nx].reshape(
            L, prob.N, prob.nx), y_dyn)
        grow = fin & (rho > 0.9)
        shrink = ~fin | (rho < 0.25)
        eta = torch.where(done, eta, torch.where(
            shrink, eta / 2.0, torch.where(grow, torch.clamp(2.0 * eta, max=prob.tr[2]), eta)))
        stationary = stationary | (~done & small & fin)
        done = done | (small & fin) | (eta < prob.tr[1])
        if bool(done.all()):
            break
    return {"X": X, "U": U, "sigma": sigma,
            "objective": prob.objective(X, sigma), "merit": merit,
            "iterations": iters, "stationary": stationary}
