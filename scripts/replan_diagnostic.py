#!/usr/bin/env python3
"""Why the port's replan path does or does not re-converge.

    python3 scripts/replan_diagnostic.py [--device cpu|cuda] [--dtype float32]
        [--kkt pcr] [--static-reg 1e-8] [--plain none|new|all]
        [--dr X,Y,Z ...] [--cap 40] [--residuals]

Drives ``chip_smoke.replan`` (the replan path of ``bench.py``: the nominal
6-DoF scenario at K=50, 8 RK4 substeps; one cold solve, then for each
``--dr`` r_init moved by it, ``scvx_warm_start`` and up to ``--cap``
general-branch SCvx iterations). float32 runs with bench.py's IPM settings
(cap 15, one refinement, Ruiz on cold solves), float64 with Ruiz on every
solve and the default IPM cap. ``--device`` defaults to the card.

``--plain`` swaps kernels for their plain PyTorch versions, on the card
too: ``new`` the replan path's ``chol`` and ``cho_solve``, ``all`` those and
``cho_solve_vec`` (so no kernel of the path runs). It tells whether a
kernel decides where the path goes.

One line per replan: iterations, converged flag, sigma, final defect plus
violation, and one letter per SCvx iteration (C: the subproblem's IPM
certified convergence; s: it stalled or hit its cap).

``--residuals`` first prints the normwise residual and forward error of
parallel cyclic reduction (``ipm._pcr_factor`` / ``_pcr_solve``) beside the
block Cholesky sweep (``smallla.blocktridiag_factor`` / ``_solve``) on one
seeded SPD block-tridiagonal system (8 blocks of 13, condition ~1e11), in
float64 on the same device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import successiveconvexification_tpu_torch as T  # noqa: E402
from successiveconvexification_tpu_torch.ops import _build, cuda_kkt, ipm, smallla  # noqa: E402
from successiveconvexification_tpu_torch.ops.precision import resolve_device  # noqa: E402

PLAIN = {"none": (), "new": ("chol", "cho_solve"),
         "all": ("chol", "cho_solve", "cho_solve_vec")}


def random_system(device, seed: int = 0, N: int = 8, n: int = 13):
    """M = R'R with R block upper bidiagonal: SPD and block tridiagonal."""
    rng = np.random.default_rng(seed)
    R = np.zeros((N * n, N * n))
    for i in range(N):
        R[i * n:(i + 1) * n, i * n:(i + 1) * n] = (
            np.eye(n) + 0.1 * rng.standard_normal((n, n)))
        if i + 1 < N:
            R[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = rng.standard_normal((n, n))
    M = R.T @ R
    D = np.stack([M[i * n:(i + 1) * n, i * n:(i + 1) * n] for i in range(N)])
    O = np.stack([M[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n]
                  for i in range(N - 1)])
    r = rng.standard_normal((1, N, n))
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return M, t(D)[None], t(O)[None], t(r)


def residuals(device) -> None:
    M, D, O, r = random_system(device)
    rn = r.cpu().numpy().reshape(-1)
    x = np.linalg.solve(M, rn)
    u_pcr = ipm._pcr_solve(ipm._pcr_factor(D, O), r)
    u_scan = smallla.blocktridiag_solve(*smallla.blocktridiag_factor(D, O), r)
    print(f"random block-tridiagonal system, condition {np.linalg.cond(M):.2e}, "
          f"float64 on {device}:")
    for name, u in (("pcr", u_pcr), ("scan", u_scan)):
        u = u.cpu().numpy().reshape(-1)
        res = np.linalg.norm(M @ u - rn) / (np.linalg.norm(M, 2) * np.linalg.norm(u))
        fwd = np.abs(u - x).max() / np.abs(x).max()
        print(f"  {name:4s}: normwise residual {res:.2e}, forward error {fwd:.2e}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--kkt", default="pcr", choices=("pcr", "scan"))
    ap.add_argument("--static-reg", type=float, default=1e-8)
    ap.add_argument("--plain", default="none", choices=tuple(PLAIN))
    ap.add_argument("--dr", action="append", default=None,
                    help="r_init move X,Y,Z (repeatable; default bench.py's)")
    ap.add_argument("--cap", type=int, default=chip_smoke.BENCH_REPLAN_ITERS)
    ap.add_argument("--residuals", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(2)
    device = resolve_device(args.device)
    if device.type == "cuda":
        _build.build_all()
        print(chip_smoke._card_line())
    for name in PLAIN[args.plain]:
        setattr(cuda_kkt, name, getattr(cuda_kkt, name + "_plain"))
    if args.residuals:
        residuals(device)
    drs = [tuple(float(v) for v in d.split(",")) for d in args.dr] \
        if args.dr else [chip_smoke.REPLAN_DR]
    cfg = chip_smoke._configs(T, args.dtype, chip_smoke.MAIN_K,
                              chip_smoke.MAIN_SUBSTEPS,
                              bench=args.dtype == "float32", kkt=args.kkt,
                              static_reg=args.static_reg)
    model = T.rocket6dof_model()
    tag = (f"{device.type} {args.dtype} {args.kkt} static_reg "
           f"{args.static_reg:g} plain={args.plain}")
    cold = None
    for dr in drs:
        t0 = time.perf_counter()
        r = chip_smoke.replan(T, model, cfg, device.type, args.cap, dr=dr,
                              cold=cold)
        sm = chip_smoke._replan_summary(r)
        if cold is None:
            cold = r["cold"]
            print(f"{tag}: cold {sm['cold_iterations']} iterations, converged "
                  f"{sm['cold_converged']}, sigma {sm['cold_sigma']:.10f}, "
                  f"{r['cold_s']:.1f} s", flush=True)
        print(f"{tag} dr {dr}: replan {sm['iterations']} iterations (cap "
              f"{args.cap}), converged {sm['converged']}, sigma "
              f"{sm['sigma']:.10f}, defect+violation "
              f"{sm['defect'] + sm['viol']:.3e}, {r['marks']}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
