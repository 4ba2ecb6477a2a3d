"""The work a kernel call must do: bytes it must move and operations it must
compute, from the call's shapes, and the H100's published peaks.

Frozen copies, so that a later change to the program cannot move the
yardstick: ``work`` and ``DYNAMICS_FLOPS`` are ``chip_smoke.py``'s ``_work``
and ``DYNAMICS_FLOPS`` at commit 0394759 (every input read once, every
output written once; the discretize kernel's operations counted on dual
numbers from its source); ``PEAKS`` is ``utils/metrics.py``'s
``CHIP_PEAKS`` at the same commit (NVIDIA's data sheet, SXM part, dense,
700 W). Two changes from ``_work``, where it reached into the program: the
discretize kernel is named ``discretize_lanes`` for either model, and its
dynamics' name is read from ``model.cuda_dynamics.name`` (what the port's
``cuda_disc.kernel_dynamics`` returns). From the program's objects this
reads only the shapes of the call's tensors, the model's widths and the
name and packed width of its kernel dynamics.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3, 700 W": {
        "hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12, "f64_flops": 34e12},
}
H100 = PEAKS["NVIDIA H100 80GB HBM3, 700 W"]

# flops of one evaluation of each model's dynamics in csrc/disc.cu, counted
# from the source on dual numbers (sign flips free): the value once, and
# each tangent direction's derivative part
DYNAMICS_FLOPS = {"rocket6dof": (133, 241), "pointmass3dof": (14, 23)}


def work(name: str, args, esize: int):
    """(bytes, flops) the function must move and compute on these inputs:
    every input read once, every output written once. ``chol`` reads only
    the lower triangle of each A block and the solves only that of each L
    block, so only it counts."""
    if name == "discretize_lanes":
        model, params, X, U, sigma, substeps, foh = args
        f_val, f_tan = DYNAMICS_FLOPS[model.cuda_dynamics.name]
        nx, nu = model.nx, model.nu
        K = X.shape[-2]
        n_sc = X.numel() // (K * nx)             # scenarios: sigma, params
        n_lanes = n_sc * (K - 1)
        n_p = model.cuda_dynamics.pack(params).shape[-1]
        elems = (X.numel() + U.numel() + n_sc * (1 + n_p)
                 + n_lanes * (nx * nx + 2 * nx * nu + 3 * nx))
        # per RK stage (csrc/disc.cu): the dynamics' value once and their
        # nx + nu tangents (DYNAMICS_FLOPS), sigma scaling of
        # [A | B], w = sA x + sB u, sA Phi, P sA, P sB, P f, P w, the lam
        # scalings, sigma f, u(tau), and the RK4 bookkeeping (13 flops a
        # carry value per step: 518 values); then Phi Bm, Phi Bp, Phi S,
        # Phi z once
        n_aug = nx + 2 * nx * nx + 2 * nx * nu + 2 * nx
        stage = (f_val + (nx + nu) * f_tan + nx * (nx + nu) + 2 * nx * (nx + nu)
                 + 2 * (2 * nx ** 3) + 2 * nx * nx * nu + 2 * (2 * nx * nx)
                 + 2 * nx * nu + nx + 3 * nu + 13 / 4 * n_aug)
        final = 2 * (2 * nx * nx * nu) + 2 * (2 * nx * nx)
        return elems * esize, n_lanes * (4 * substeps * stage + final)
    if name == "fused_factor":
        G, wrow, uv, ucoef, hdiag, E, F, dpq, rng = args
        B, K, R, nw = G.shape
        nrx, S = E.shape[2], ucoef.shape[-1]
        elems = (G.numel() + wrow.numel() + uv.numel() + ucoef.numel()
                 + hdiag.numel() + E.numel() + F.numel() + dpq.numel()
                 + B * K * nw * nw + 2 * B * (K - 1) * nrx * nrx)
        r_soc = int((rng[:, 1] - rng[:, 0]).sum())
        low_w, low_x = nw * (nw + 1) // 2, nrx * (nrx + 1) // 2
        per_node = (2 * r_soc * nw + low_w * (3 * R + 3 * S) + nw ** 3 / 3
                    + 4 * nrx * nw * nw)
        per_block = (6 * nrx * nrx * nw + nrx ** 3 + 2 * nrx * low_x
                     + nrx ** 3 / 3)
        flops = B * (K * per_node + (K - 1) * per_block)
        return elems * esize + rng.numel() * 4, flops
    if name == "tridiag_factor":   # reads D's lower triangle and O
        D, O = args
        B, N, n, _ = D.shape
        low = n * (n + 1) // 2
        elems = B * N * low + O.numel() + 2 * D.numel()
        # C_k: n forward substitutions of n^2 flops; S_k's lower triangle:
        # 2n a entry; chol n^3 / 3
        flops = B * ((N - 1) * n ** 3 + N * (2 * n * low + n ** 3 / 3))
        return elems * esize, flops
    if name == "fused_chol_solve":  # A's lower triangle, B, X
        A, b = args
        n, m = A.shape[-1], b.shape[-1]
        N = A.numel() // (n * n)
        return ((N * n * (n + 1) // 2 + 2 * b.numel()) * esize,
                N * (n ** 3 / 3 + 2 * n * n * m))
    if name == "tridiag_solve":
        L, C, r = args
        B, N, n, _ = L.shape
        low = B * N * n * (n + 1) // 2
        return (low + C.numel() + 2 * r.numel()) * esize, 6 * B * N * n * n
    if name == "chol":      # reads A's lower triangle, writes all of L
        (A,) = args
        n = A.shape[-1]
        N = A.numel() // (n * n)
        return (N * n * (n + 1) // 2 + A.numel()) * esize, N * n ** 3 / 3
    L, b = args       # cho_solve_vec, cho_solve: 2 n^2 flops a column
    n = L.shape[-1]
    N = L.numel() // (n * n)
    return (N * n * (n + 1) // 2 + 2 * b.numel()) * esize, 2 * n * b.numel()


def bound_s(name: str, args, esize: int) -> float:
    """The least time the H100 could take for the call: the larger of its
    bytes over peak bandwidth and its operations over peak rate."""
    nbytes, flops = work(name, args, esize)
    peak = H100["f64_flops"] if esize == 8 else H100["f32_flops"]
    return max(nbytes / H100["hbm_bytes_per_s"], flops / peak)
