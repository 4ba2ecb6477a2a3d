#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``successiveconvexification_tpu_torch``
from beside this file and never imports JAX or the JAX package). Phases:

  1. the card's name and power limit (nvidia-smi) and the kernels' build
     (three sources, one nvcc each, in parallel);
  2. the main path: a B=256 Monte-Carlo sweep of the 6-DoF rocket at K=50,
     8 RK4 substeps, float32, with the settings of ``bench.py`` (IPM cap 15,
     one refinement step, warm start, scan KKT, Ruiz on cold solves, SCvx
     cap 120, compaction with min bucket 32 and chunk 10), dispersions from
     a torch.Generator seeded with 0. Every kernel launch counter is set to
     0 just before and read just after; every kernel must have launched,
     and the counts must match the IPM's structure (and one discretize
     launch per lockstep SCvx iteration);
  2b. the replan path (``bench.py``'s BENCH_MODE=replan, the same settings
     with the PCR KKT backend): a cold single-lane solve of the nominal
     scenario, r_init moved by (0.2, -0.2, 0.1), ``scvx_warm_start`` with
     the STM correction, then general-branch SCvx iterations with a device
     sync after each until the lane re-converges, at most bench.py's 40.
     Counters as in phase 2: chol, cho_solve and cho_solve_vec must match
     the IPM's structure, discretize launch once per SCvx iteration and
     once in the warm start, and the fused route's kernels must not
     launch; the cold solve must converge. Then one warm
     replan iteration under torch.profiler (device busy share, device
     operations, aten calls), and the same path at static_reg 1e-6
     (``REPLAN_CHECK_REG`` says why) with bench.py's cap of 40: its cold
     solve must converge and its replan must re-converge;
  2c. the penalized path: the main path's sweep (the same dispersions and
     settings) of the rocket with one penalized direction a node, the unit
     thrust direction (``penalized_model``), so the subproblems have
     rank-one quadratic rows and the ``scan`` route factors without the
     fused kernel: chol, cho_solve, the block-tridiagonal factor
     (tridiag_factor), tridiag_solve and cho_solve_vec must match the IPM's
     structure and the fused factor must not launch; the converged sigma
     is compared lane by lane with the main path's;
  2d. the point-mass path: a B=256 sweep of the 3-DoF point mass at K=30
     with a fixed final time (BASELINE config 1, minimum fuel), the main
     path's dispersion stds and settings; the fused route's kernels and the
     discretize kernel's point-mass instantiation must launch as the IPM's
     structure says;
  2e. the factor-and-solve kernel (fused_chol_solve) on its only caller in
     the JAX package, the test vehicle of ``tests/test_pallas_kkt.py``:
     N=300 SPD 13 x 13 blocks, two right-hand sides, f64, against
     ``torch.linalg.solve`` within that test's tolerance;
  2f. the seeded path (``bench.py``'s BENCH_MODE=seeded): the nominal
     scenario solved once, cold (``scvx_solve``, its wall printed apart as
     nominal_s), then ``solve_batch_seeded`` from it over the main path's
     256 dispersions at the main path's settings (min bucket 32); launch
     counters set to 0 around the nominal and around the sweep, matched
     to the IPM's structure as in phase 2 (and one discretize for the
     warm start); the nominal must converge, every converged lane meet
     the solver's feasibility floor, the mean iterations a lane fall below
     the cold main path's, and no lane converged on both paths have a
     sigma 5e-2 or more above the cold one's (the JAX package's
     ``tests/test_seeded.py`` gates; its two-sided sigma gate is held in
     f64, phase 4: in f32 the cold path stops above the optimum in many
     lanes);
  2g. the atmospheric variants: (a) an angle-of-attack STC solve
     (``rocket6dof_model(aoa_stc=True)``, K=14, 5 substeps, IPM cap 30, two
     refinement steps, f64, at most 45 iterations, as
     ``tests/test_stc.py``): it must converge with defect < 1e-3 and
     violation < 1e-4, its worst angle of attack above alpha_max over the
     nodes faster than the trigger speed below 1 degree, the fused route's
     kernels launching as the IPM's structure says, and its fused_factor
     calls one row larger (R) than the vacuum model's; (b) a drag solve
     (cd_a 0.05, ``tests/test_scvx.py``'s settings, at most 40 iterations)
     batched with the vacuum scenario, both under the same gates against
     a propagate at four times the substeps, the drag lane's sigma more
     than 1e-3 from the vacuum lane's; (c) and (d) the CLI
     on the card in child processes, started beside phase 4's card runs:
     ``cli solve --model rocket6dof_stc`` with (a)'s settings as dotted
     overrides must give (a)'s sigma within 1e-6 relative, and ``cli sweep
     --seeded --batch 8 --disc.K=14 --metrics --checkpoint`` must write a
     manifest and one record with the JAX CLI's keys and a checkpoint that
     restores bit for bit to the state of the same sweep run in this
     process;
  2h. the sharded sweep on the card, in child processes started first
     beside phase 4's card runs: (a) the main path's sweep (its
     dispersions, width and settings, without compaction) by
     ``solve_batch`` and by ``run_batch`` on an NCCL group of one rank
     with a commit every 10 SCvx iterations, in one child: the final
     states must be equal bit for bit, the launch counters (set to 0
     around each run) must match the IPM's structure, and each run's wall
     and the mean host time of a commit are printed; (b) the point-mass
     path under ``run_batch`` with a commit every 5 iterations,
     uninterrupted in one child and, beside it, in a child that hard-exits
     right after its step-10 commit; a fresh child resumes the crashed
     run's shard files, and its final state must be the uninterrupted
     run's bit for bit; (c) ``cli sweep --distributed --num-processes 1
     --ckpt-every 2 --batch 8 --disc.K=14`` twice: the second run resumes
     the finished sweep and must print the same n_total and
     mean_iterations;
  2i. the ksharded KKT backend on an NCCL group of one rank, in a child
     process started beside phase 4's card runs: (a) the JAX package's
     reference subproblem (``tests/test_parallel.py:147``: the rocket at
     K=50, 3 substeps, f64, IPM cap 45, one refinement step, the first
     subproblem from ``scvx_init``) solved on the card with ksharded and
     with scan, w within atol 1e-6 and sig within 1e-8 (that test's gate),
     and with ksharded on the CPU (plain versions) within the same gate of
     the card's and with as many IPM iterations; (b) ``scvx_solve`` of the
     nominal rocket with ksharded at the main path's settings, which must
     converge with a sigma within 1e-2 of phase 4's f64 nominal on the
     card (the JAX package's f32-against-f64 gate at K=50) and no more
     than 1e-3 relative above the lower of phase 2b's cold PCR solve and
     phase 2f's cold nominal (one-sided: in f32 those cold solves stop
     above the optimum on the card), its iterations and wall printed
     beside both; (c) launch
     counters set to 0 around (b), matched to the IPM's structure for the
     route (``KSHARDED_PER_ITER``, ``KSHARDED_PER_COLD``; the fused factor
     must not launch); (d) tridiag_factor and tridiag_solve against their
     plain versions (``check_call``'s gates) on (b)'s calls: the interior
     chain (48 blocks), the reduced system at N = 1 and the matrix
     right-hand side's columns folded into lanes; (e) (a)'s subproblem with
     two Gondzio correctors an IPM iteration, ksharded against scan on the
     card (the gate of (a)) and against ksharded without them (the JAX
     package's gate, ``tests/test_ipm_structured.py:185-196``: at most two
     more IPM iterations, w within atol 5e-6), its launches matched to the
     route's structure with the corrector terms (``per_iter``);
  2j. the Gondzio correctors and the host-compacting sweep, in a child
     process started beside phase 4's card runs: (a) 2i's reference
     subproblem on the fused scan, on PCR and, with the penalized path's
     model, on the unfused scan, each on the card without correctors and
     with two (the JAX package's gate between them), and with two on the
     CPU (plain versions; w within atol 1e-6, sig within 1e-8, equal IPM
     iterations), launches counted around each card solve and matched to
     the route's structure with the corrector terms; (b) ``scvx_solve`` of
     the nominal rocket at the main path's settings with two correctors on
     the fused route, gated as 2i (b), its SCvx and IPM iterations and ms
     per SCvx iteration printed beside phase 2f's nominal; (c) the main
     path's sweep under ``solve_batch_compact`` (host compaction, chunk 10,
     min bucket 32): its final state must be phase 2's bit for bit, leaf by
     leaf (saved to a file), it must repack and launch as the IPM's
     structure says; its wall, its repacks and the mean host round trip a
     chunk are printed;
  3. each kernel against its plain PyTorch version on inputs captured from
     those runs (main path: its first call inside the first IPM iteration,
     and every call of the 10th lockstep SCvx iteration, every third of
     tridiag_solve, whose warm IPM ends near optimality where conditioning
     is worst; replan path: the first IPM
     iteration of the cold solve and every call of the last replan
     iteration, cho_solve_vec as well; penalized path: chol, cho_solve,
     tridiag_factor, tridiag_solve and cho_solve_vec, and point-mass path:
     the fused route's three kernels,
     both as the main path's kernels; the seeded path's nominal (B=1):
     the fused route's three kernels at its first IPM iteration; the STC
     solve's fused_factor (R one larger) at its first IPM iteration and
     its 10th SCvx iteration; chol and cho_solve block by block;
     fused_chol_solve on synthetic SPD batches at the vehicle's shape and at
     the penalized path's stage-Hessian shape; and the generic-width
     instantiations, chol at GENERIC_CHOL and fused_chol_solve at
     GENERIC_FCS, on synthetic SPD blocks with a quarter of the lower
     triangle exact zeros), in float32 and float64: the
     kernel must be finite wherever success in its dtype is guaranteed, and
     there its residuals within their backward-error bounds and its error
     against the float64 plain version within the forward error those
     bounds permit (``check_call``); the discretize kernel against its plain
     version on the main path's first and 10th lockstep calls, the last call
     of each replan run, a synthetic call with drag and a NaN lane, the
     drag solve's first call, and the
     point-mass path's first and 10th calls and a NaN lane, each gated per
     lane and output (``check_disc``), with the gap between the kernel's
     x_prop and the plain ``propagate``'s printed; chol, fused_chol_solve
     and tridiag_factor at an infinite and at a negative pivot (synthetic,
     ``check_pivots``): non-finite exactly where the float64 plain version
     on the CPU is (an infinite pivot factors on, as LAPACK's potrf does; a
     negative one gives NaN, and in tridiag_factor NaN in every later block
     of the lane), the rest within the forward gate or bit-equal to the
     kernel's output without the special pivots; the wrappers must refuse
     what the kernels do not take (cho_solve: any layout but the ones it
     reads in place);
  4. f64 on the card beside the same runs on the CPU with the plain
     versions (child processes, each of the card's too, Ruiz on every
     solve): B=4 of the main path,
     of the seeded path (its nominal too) and of the penalized path at K=50,
     B=4 of the point-mass path at K=30,
     and the replan path at K=50 with the static KKT regularization at 1e-6
     (``REPLAN_CHECK_REG`` says why); sigma (X and U for the fixed-time
     point mass) within 1e-6 relative, identical iteration counts and
     converged flags; the seeded lanes' sigma within 5e-2 of the main
     case's, on the card and on the CPU; and, as a reading, the penalized case again on the
     card with tridiag_factor's plain version (a child process beside the
     card runs), to show how far a change of summation order alone moves
     sigma;
  5. a profile of one cho_solve call of the replan and of the penalized
     path, as the IPM makes it, in a child process: its kernel must be its
     only device operation (L and B are read in place, not copied); then
     each kernel's time at its path's shapes beside its bound, its plain
     version's time and, where one exists, one PyTorch library call's time
     (chol and cho_solve also at a B=256 batch of blocks, for the record,
     and cho_solve on the penalized path's call as the IPM makes it;
     fused_chol_solve at both of its phase-3 shapes; fused_factor at the
     seeded nominal's B=1 and at the STC solve's R; chol at its generic
     width beside the first design's time there; tridiag_solve also on
     the penalized path, and it and fused_factor at the point mass's
     shapes; tridiag_factor also in float64; cho_solve_vec at every path's
     shapes); and the synchronized
     wall of one ``discretize`` call at B=256 with the kernel against the
     same call with the plain version, median of 5.

The line before the last is the kernels' JSON record; the last line is the
run's verdict ``{"ok": true, "device": {...}}``; the total wall is printed
before them. Any failed phase exits
non-zero without that line. ``--cpu-reference PATH CASE`` (CASE: main,
penalized or pointmass) and ``--cpu-replan PATH`` (CPU only) and
``--card-plain-factor PATH`` are the child modes of phase 4,
``--sharded-sweep PATH``, ``--sharded-resume PATH`` and ``--pm-run-batch
CKPT MODE PATH`` those of phase 2h, ``--ksharded PATH`` that of phase 2i,
``--gondzio-host PATH STATE`` that of phase 2j, ``--profile-cho-solve
PATH`` that of phase 5.
``--save-captures PATH`` runs every phase and also saves the captured
inputs of tridiag_factor, cho_solve_vec, chol and cho_solve (the replan
and penalized paths' calls, cho_solve's as the IPM makes them) and
discretize_lanes (the first and a late call of every path) (a few hundred
MB) for
``scripts/kernel_ab.py``, ``scripts/kernel_stamps.py`` and
``scripts/disc_stamps.py``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

sys.path.insert(0, ROOT)
# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity, 700 W),
# from the port's table; without the port beside this file main() refuses
# to run before any of them is read
try:
    from successiveconvexification_tpu_torch.utils.metrics import CHIP_PEAKS
except ImportError:
    CHIP_PEAKS = None
_PEAKS = (CHIP_PEAKS or {}).get("NVIDIA H100 80GB HBM3, 700 W", {})
PEAK_BYTES_PER_S = _PEAKS.get("hbm_bytes_per_s")
PEAK_FLOPS = {"float32": _PEAKS.get("f32_flops"),
              "float64": _PEAKS.get("f64_flops")}

MAIN_B, MAIN_K, MAIN_SUBSTEPS = 256, 50, 8
REF_B = 4
REPLAN_DR = (0.2, -0.2, 0.1)    # bench.py's replan move of r_init
BENCH_REPLAN_ITERS = 40         # bench.py's replan loop
# Static KKT regularization of the replan run that must re-converge and of
# the f64 card-vs-CPU replan. At the default 1e-8 the PCR solve's residual
# plateaus late in the IPM (PCR's combined solution does not solve one
# nearby system), so most subproblems end uncertified and the summation
# order decides the path. At 1e-6 every late subproblem certifies, and in
# f64 PCR gives the scan route's trajectory (ROADMAP Queue 3;
# scripts/replan_diagnostic.py takes these readings).
REPLAN_CHECK_REG = 1e-6
# w_dir_penalty of the penalized path: the weight of the quadratic penalty on
# throttle moves: the largest power of ten from 1.0 down at which the f64
# nominal solve converges within the cap in both packages (PERF.md section 6)
PENALTY_W = 0.1
# the JAX CLI's sweep record (successiveconvexification_tpu/cli.py:195-202)
CLI_SWEEP_KEYS = {"n_converged", "n_total", "mean_iterations", "mean_sigma",
                  "max_nu_norm", "wall_s", "solves_per_s"}
PM_K = 30                       # BASELINE config 1: point mass, K=30
ATMO_K = 14                     # the atmospheric variants' horizon (tests)
# torch threads of phase 4's CPU children (the machine has 8 cores)
CPU_THREADS = {"main": 3, "penalized": 2, "pointmass": 1, "seeded": 1}
VEHICLE = (300, 13, 2)          # tests/test_pallas_kkt.py:28, N, n, m
# the generic-width instantiations of chol and fused_chol_solve (n not
# compiled in), held in phase 3 at a ragged N (N, n) and (N, n, m), and
# chol timed there in phase 5 beside the first design's time at the same
# shape, f32, from scripts/kernel_ab.py (its synthetic input: a quarter of
# the lower triangle exact zeros; NVIDIA H100 80GB HBM3, 700 W)
GENERIC_CHOL = (9001, 20)
GENERIC_FCS = (4099, 20, 7)
GENERIC_CHOL_FIRST_DESIGN_MS = 0.0379

KERNELS = {
    "fused_factor": dict(
        source="successiveconvexification_tpu_torch/csrc/fused_factor.cu",
        replaces="successiveconvexification_tpu/ops/pallas_fused.py:245"),
    "tridiag_solve": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:451"),
    "cho_solve_vec": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:201"),
    "chol": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:160"),
    "cho_solve": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:201"),
    "discretize_lanes": dict(
        source="successiveconvexification_tpu_torch/csrc/disc.cu",
        replaces="successiveconvexification_tpu/ops/pallas_disc.py:144"),
    "tridiag_factor": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:404"),
    "fused_chol_solve": dict(
        source="successiveconvexification_tpu_torch/csrc/kkt.cu",
        replaces="successiveconvexification_tpu/ops/pallas_kkt.py:512"),
}
# the discretize kernel's point-mass instantiation, recorded as its own row
PM_DISC = "discretize_lanes[pointmass3dof]"
KERNELS[PM_DISC] = KERNELS["discretize_lanes"]
WRAPPED = ("fused_factor", "tridiag_solve", "cho_solve_vec", "chol",
           "cho_solve", "tridiag_factor", "fused_chol_solve", "discretize_lanes")


def _counts(**nonzero) -> dict:
    return {k: nonzero.get(k, 0) for k in WRAPPED}


# launches per IPM iteration and per cold init (ipm.py structure). An IPM
# iteration factors once and runs three KKT solves (predictor, corrector,
# one refinement), each with two stage-Hessian solves; a cold init factors
# once and runs two KKT solves. The fused route adds a tridiag_solve per
# KKT solve and one for the Sherman-Morrison vector; the unfused routes
# factor H with chol and form H^-1 E', H^-1 F' with two cho_solve
# launches, then the Schur system: by PCR (plain, the replan path) or by
# tridiag_factor with the fused route's tridiag_solves (the penalized
# path). Every SCvx iteration discretizes once (PER_SCVX), and so does the
# replan's warm start.
PER_ITER = _counts(fused_factor=1, tridiag_solve=4, cho_solve_vec=6)
PER_COLD = _counts(fused_factor=1, tridiag_solve=3, cho_solve_vec=4)
REPLAN_PER_ITER = _counts(cho_solve_vec=6, chol=1, cho_solve=2)
REPLAN_PER_COLD = _counts(cho_solve_vec=4, chol=1, cho_solve=2)
PENALIZED_PER_ITER = _counts(chol=1, cho_solve=2, tridiag_factor=1,
                             tridiag_solve=4, cho_solve_vec=6)
PENALIZED_PER_COLD = _counts(chol=1, cho_solve=2, tridiag_factor=1,
                             tridiag_solve=3, cho_solve_vec=4)
# the ksharded backend (phase 2i) takes the unfused route: chol and two
# cho_solve, then ksharded_factor, which factors the interior chain
# (tridiag_factor) and forms Ya and Zb (a tridiag_solve on the folded
# columns each); every ksharded_solve (the Sherman-Morrison vector and each
# KKT solve) solves the interior (tridiag_solve) and factors and solves the
# reduced separator system (tridiag_factor, tridiag_solve), one block at
# one rank
KSHARDED_PER_ITER = _counts(chol=1, cho_solve=2, tridiag_factor=1 + 4,
                            tridiag_solve=2 + 2 * 4, cho_solve_vec=6)
KSHARDED_PER_COLD = _counts(chol=1, cho_solve=2, tridiag_factor=1 + 3,
                            tridiag_solve=2 + 2 * 3, cho_solve_vec=4)
# the atmospheric variants' IPM runs two refinement steps: four KKT solves
# an iteration
PER_ITER_REFINE2 = _counts(fused_factor=1, tridiag_solve=5, cho_solve_vec=8)
# a Gondzio corrector (phase 2j) is one more unrefined KKT solve an IPM
# iteration on its factors: two stage-Hessian solves and the Schur solve,
# which is one tridiag_solve on the fused and penalized routes, plain on
# PCR, and one ksharded_solve on ksharded (the interior's tridiag_solve,
# the reduced system's tridiag_factor and tridiag_solve)
CORRECTOR = {"scan": _counts(tridiag_solve=1, cho_solve_vec=2),
             "penalized": _counts(tridiag_solve=1, cho_solve_vec=2),
             "pcr": _counts(cho_solve_vec=2),
             "ksharded": _counts(tridiag_factor=1, tridiag_solve=2,
                                 cho_solve_vec=2)}
GONDZIO = 2                     # phase 2j's correctors an IPM iteration


def per_iter(route: str, g: int = 0) -> dict:
    """Launches an IPM iteration on ``route`` with ``g`` correctors."""
    base = {"scan": PER_ITER, "penalized": PENALIZED_PER_ITER,
            "pcr": REPLAN_PER_ITER, "ksharded": KSHARDED_PER_ITER}[route]
    return {k: base[k] + g * CORRECTOR[route][k] for k in base}


PER_COLD_OF = {"scan": PER_COLD, "penalized": PENALIZED_PER_COLD,
               "pcr": REPLAN_PER_COLD, "ksharded": KSHARDED_PER_COLD}
PER_SCVX = _counts(discretize_lanes=1)
LATE_LOCKSTEP = 10
# phase 2h: (a) run_batch's commit cadence at the main path's width, (b)
# the point-mass crash and resume: a commit every 5 SCvx iterations and a
# crash right after the step-10 commit, (c) the CLI's cadence
SHARD_B = MAIN_B
SHARD_CKPT_EVERY = 10
PM_CKPT_EVERY, PM_CRASH_STEP = 5, 10
CLI_CKPT_EVERY = 2


class PhaseError(RuntimeError):
    pass


def _import_port():
    sys.path.insert(0, ROOT)
    import successiveconvexification_tpu_torch as P  # noqa: F401
    from successiveconvexification_tpu_torch.ops import (_build, cuda_disc,
                                                         cuda_fused, cuda_kkt)

    return P, _build, cuda_fused, cuda_kkt, cuda_disc


def _configs(P, dtype: str, K: int, substeps: int, bench: bool,
             kkt: str = "scan", static_reg: float = 1e-8,
             free_final_time: bool = True, **scvx):
    """The solver settings of a path: bench.py's (``bench``) or the f64
    card-vs-CPU check's; ``scvx`` overrides ScvxConfig fields."""
    if bench:
        ipm = P.IPMConfig(max_iters=15, refine_steps=1, warm_start=True,
                          use_pallas=True, kkt_solver=kkt,
                          static_reg=static_reg)
    else:
        # the f64 card-vs-CPU check: Ruiz on every solve and the default IPM
        # cap keep each subproblem solved to tolerance, so the two runs stay
        # on one path (capped, unequilibrated warm solves make the f64 IPM
        # path sensitive to summation order)
        ipm = P.IPMConfig(equilibrate_cold_only=False, kkt_solver=kkt,
                          static_reg=static_reg)
    return P.SolverConfig(
        dtype=dtype, disc=P.DiscretizationConfig(K=K, substeps=substeps),
        ipm=ipm, scvx=dataclasses.replace(P.ScvxConfig(), max_iters=120,
                                          **scvx),
        free_final_time=free_final_time)


def _dispersed(P, B: int, dtype, device, pointmass: bool = False):
    """B dispersions of the model's default scenario with the main path's
    stds, drawn from a torch.Generator seeded with 0."""
    import torch
    from successiveconvexification_tpu_torch.models import pointmass3dof as pm
    from successiveconvexification_tpu_torch.models import rocket6dof as rk

    params = (pm if pointmass else rk).default_params(dtype=dtype, device=device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    return P.sample_dispersions(params, gen, B, r_std=0.2, v_std=0.1,
                                m_frac_std=0.03)


def _throttle_dirs(params, xk, uk):
    """One penalized direction a node: the unit thrust direction (0_nx,
    u/|u|), a soft limit on throttle moves between iterates."""
    import torch
    from successiveconvexification_tpu_torch.models.base import safe_norm

    n = uk / safe_norm(uk)[..., None]
    return torch.cat([torch.zeros_like(xk), n], dim=-1)[..., None, :]


def penalized_model(P):
    """The rocket with the throttle direction penalized: its subproblems
    have rank-one quadratic rows (Q_r1)."""
    return dataclasses.replace(P.rocket6dof_model(), name="rocket6dof_throttle",
                               penalized_dirs=_throttle_dirs)


def reference_case(P, case: str, device: str):
    """(model, params batch, cfg) of the f64 card-vs-CPU check ``case``:
    B=4 of the main path (and of the seeded path, which sweeps the same
    lanes), of the penalized path or of the point-mass path."""
    import torch

    if case == "pointmass":
        cfg = _configs(P, "float64", PM_K, MAIN_SUBSTEPS, bench=False,
                       free_final_time=False, w_sigma=0.0, w_mass=1.0)
        return (P.pointmass3dof_model(),
                _dispersed(P, REF_B, torch.float64, device, pointmass=True), cfg)
    pb = _dispersed(P, REF_B, torch.float64, device)
    if case == "penalized":
        cfg = _configs(P, "float64", MAIN_K, MAIN_SUBSTEPS, bench=False,
                       w_dir_penalty=PENALTY_W)
        return penalized_model(P), pb, cfg
    return P.rocket6dof_model(), pb, _configs(P, "float64", MAIN_K,
                                              MAIN_SUBSTEPS, bench=False)


def reference_run(P, case: str, device: str) -> dict:
    """The f64 card-vs-CPU check ``case`` on ``device``: its summary, and
    for the seeded case the nominal's too (solved first, then the seeded
    sweep of the main case's lanes from it)."""
    import torch
    from successiveconvexification_tpu_torch.models import rocket6dof as rk

    model, pb, cfg = reference_case(P, case, device)
    if case != "seeded":
        return _reference_summary(P.solve_batch(model, pb, cfg, device=device))
    nom = P.scvx_solve(model, rk.default_params(torch.float64, device), cfg,
                       device=device)
    st = P.solve_batch_seeded(model, pb, cfg, nominal_solution=(
        nom.X[0], nom.U[0], nom.sigma[0]), device=device)
    return {**_reference_summary(st), "nominal": _reference_summary(nom)}


def atmo_cfg(P, scvx_cap: int):
    """The atmospheric variants' settings (tests/test_stc.py:75-115,
    tests/test_scvx.py:284-303): K=14, 5 substeps, IPM cap 30, two
    refinement steps, f64; ``scvx_cap`` SCvx iterations at most."""
    return P.SolverConfig(
        dtype="float64", disc=P.DiscretizationConfig(K=ATMO_K, substeps=5),
        ipm=P.IPMConfig(max_iters=30, refine_steps=2),
        scvx=dataclasses.replace(P.ScvxConfig(), max_iters=scvx_cap))


def aoa_excess(X, params) -> float:
    """The worst angle of attack above alpha_max, in degrees, over the
    nodes of one trajectory X (K, nx) faster than the trigger speed (+1e-3),
    and 0 if none exceeds it (tests/test_stc.py:103-115)."""
    import torch
    from successiveconvexification_tpu_torch.utils.quaternion import quat_to_dcm

    X = X.detach().double().cpu()
    v = X[:, 4:7]
    speed = torch.linalg.vector_norm(v, dim=-1)
    v_b = (quat_to_dcm(X[:, 7:11]).transpose(-1, -2) @ v[..., None])[..., 0]
    aoa = torch.rad2deg(torch.arccos(torch.clamp(-v_b[:, 0] / speed, -1, 1)))
    excess = aoa - math.degrees(math.acos(float(params.cos_aoa_max)))
    fast = speed > float(params.v_trigger) + 1e-3
    return max(0.0, float(excess[fast].max())) if bool(fast.any()) else 0.0


def quality(model, pb, cfg, st):
    """Per lane (max |defect|, cone violation) of a batch of solutions, the
    defect against the plain propagate at four times the substeps
    (tests/test_scvx.py:39-44)."""
    from successiveconvexification_tpu_torch.ops.discretize import propagate
    from successiveconvexification_tpu_torch.ops.scvx import cone_violation

    xp = propagate(model, pb, st.X, st.U, st.sigma,
                   substeps=4 * cfg.disc.substeps, foh=cfg.disc.foh)
    return ((xp - st.X[:, 1:]).abs().amax(dim=(1, 2)).tolist(),
            cone_violation(model, pb, st.X, st.U).tolist())


def _bits(t):
    """A tensor's bits, so that equal NaNs compare equal."""
    import torch

    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def replan(P, model, cfg, device: str, cap: int, before=None, after=None,
           dr=REPLAN_DR, cold=None):
    """The replan path: a cold single-lane solve of the nominal scenario
    (or the given ``cold`` solution), r_init moved by ``dr``,
    ``scvx_warm_start`` with the STM correction, then general-branch SCvx
    iterations until the lane converges (at most ``cap``), with a device
    sync after each (bench.py's replan mode). ``before``/``after`` are
    called around each replan iteration. ``marks`` has one letter per
    replan iteration: C where its IPM certified convergence, s where not."""
    import torch
    from successiveconvexification_tpu_torch.models import rocket6dof as rk

    dtype = getattr(torch, cfg.dtype)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    params = rk.default_params(dtype=dtype, device=device)
    sync()
    t0 = time.perf_counter()
    if cold is None:
        cold = P.scvx_solve(model, params, cfg, device=device)
    sync()
    cold_s = time.perf_counter() - t0
    p2 = params.replace(r_init=params.r_init + torch.tensor(
        dr, dtype=dtype, device=device)).map(lambda v, tail: v[None])
    t0 = time.perf_counter()
    warm0 = P.scvx_warm_start(model, p2, cfg, cold.X[0], cold.U[0],
                              cold.sigma[0])
    sync()
    warm_start_ms = 1e3 * (time.perf_counter() - t0)
    warm, lat_ms, marks = warm0, [], ""
    for _ in range(cap):
        if before:
            before()
        t0 = time.perf_counter()
        warm = P.scvx_iteration(model, p2, cfg, warm)
        sync()
        lat_ms.append(1e3 * (time.perf_counter() - t0))
        if after:
            after()
        marks += "C" if bool(warm.ipm_carry.converged.all()) else "s"
        if bool(warm.converged.all()):
            break
    return dict(cold=cold, warm=warm, warm0=warm0, params=p2, cold_s=cold_s,
                warm_start_ms=warm_start_ms, lat_ms=lat_ms, marks=marks)


def run_replan(P, batch_mod, model, cfg, wrappers, caps, cap: int, card: str):
    """Drive the replan path on the card with every launch counter set to 0
    just before and read just after; print its line and its launches, and
    fail unless the trajectories are finite and the counts match the IPM's
    structure (chol, cho_solve and cho_solve_vec launched, the fused route's
    kernels not; discretize once per SCvx iteration and once in the warm
    start). ``caps`` keep the inputs of the first IPM iteration of the cold
    solve and of every call of the last replan iteration."""
    import torch

    n_solve_cold = {"n": 0, "all": 0}
    orig_iter = batch_mod.scvx_iteration

    def counting_iteration(model_, params_, cfg_, st_, assume_warm_valid=False):
        n_solve_cold["n"] += 0 if assume_warm_valid else 1
        n_solve_cold["all"] += 1
        return orig_iter(model_, params_, cfg_, st_,
                         assume_warm_valid=assume_warm_valid)

    def before():
        for c in caps.values():
            c.recent.clear()

    def after():
        for c in caps.values():
            c.late = list(c.recent)

    batch_mod.scvx_iteration = counting_iteration
    try:
        for w in wrappers.values():
            w.launches = 0
        r = replan(P, model, cfg, "cuda", cap, before, after)
        launches = {k: w.launches for k, w in wrappers.items()}
    finally:
        batch_mod.scvx_iteration = orig_iter
    sm = r["summary"] = _replan_summary(r)
    lat = sorted(r["lat_ms"])
    print(f"replan path: K={MAIN_K} {cfg.dtype} PCR, static_reg "
          f"{cfg.ipm.static_reg:g}: cold solve {r['cold_s']:.3f} s, "
          f"{sm['cold_iterations']} iterations, converged "
          f"{sm['cold_converged']}; warm start {r['warm_start_ms']:.1f} ms; "
          f"replan {sum(lat):.1f} ms, {len(lat)} iterations (cap {cap}), ms "
          f"per SCvx iteration p50 {lat[len(lat) // 2]:.1f} max {lat[-1]:.1f}, "
          f"re-converged {sm['converged']}, final defect+violation "
          f"{sm['defect'] + sm['viol']:.3e}, sigma {sm['cold_sigma']:.5f} -> "
          f"{sm['sigma']:.5f}; {card}")
    # every replan iteration is a general-branch one: it pays a cold init
    n_cold = n_solve_cold["n"] + len(lat)
    n_body = launches["chol"] - n_cold
    # SCvx iterations of the cold solve and of the replan, and the warm start
    n_scvx = n_solve_cold["all"] + len(lat) + 1
    expect = {k: REPLAN_PER_ITER[k] * n_body + REPLAN_PER_COLD[k] * n_cold
              + PER_SCVX[k] * n_scvx for k in launches}
    print(f"  launches: {json.dumps(launches)}; expected from {n_body} IPM "
          f"iterations + {n_cold} cold inits + {n_scvx} discretizations "
          f"({n_solve_cold['all']} + {len(lat)} SCvx iterations and the warm "
          f"start): {json.dumps(expect)}")
    if not all(bool(torch.isfinite(t).all()) for st in (r["cold"], r["warm"])
               for t in (st.X, st.U, st.sigma)):
        raise PhaseError("replan path: non-finite trajectories")
    if any(launches[k] == 0 for k in ("chol", "cho_solve", "cho_solve_vec",
                                       "discretize_lanes")):
        raise PhaseError(f"replan path: a kernel never launched: {launches}")
    if launches != expect:
        raise PhaseError("replan path: launch counts do not match the IPM "
                         "(the fused route must not launch)")
    return r, launches


def _replan_summary(r) -> dict:
    cold, warm = r["cold"], r["warm"]
    return {"cold_iterations": int(cold.iterations[0]),
            "cold_converged": bool(cold.converged[0]),
            "cold_sigma": float(cold.sigma[0]),
            "iterations": int(warm.iterations[0]),
            "converged": bool(warm.converged[0]),
            "sigma": float(warm.sigma[0]),
            "defect": float(warm.defect_nl[0]),
            "viol": float(warm.viol_nl[0])}


def cpu_replan(path: str) -> None:
    """Child mode: the f64 K=50 replan path on the CPU with the plain versions."""
    import torch

    torch.set_num_threads(2)
    P, *_ = _import_port()
    cfg = _configs(P, "float64", MAIN_K, MAIN_SUBSTEPS, bench=False, kkt="pcr",
                   static_reg=REPLAN_CHECK_REG)
    t0 = time.perf_counter()
    r = replan(P, P.rocket6dof_model(), cfg, "cpu", cfg.scvx.max_iters)
    out = {**_replan_summary(r), "seconds": time.perf_counter() - t0}
    with open(path, "w") as f:
        json.dump(out, f)


def reference_child(path: str, case: str, device: str) -> None:
    """Child mode: the f64 B=4 run of ``case`` on the CPU with the plain
    versions, or on the card with the kernels (built by the parent)."""
    import torch

    torch.set_num_threads(CPU_THREADS[case] if device == "cpu" else 1)
    P, *_ = _import_port()
    t0 = time.perf_counter()
    out = reference_run(P, case, device)
    if device == "cuda":
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)


def profile_cho_solve(path: str) -> None:
    """Child mode of phase 5: the device operations of one cho_solve call
    on each call saved at ``path`` (the replan and penalized paths' first
    calls, L and B as the IPM makes them), with their shapes and strides,
    to ``path``.json. A fresh process: in the parent, a trace taken after
    phase 2b's recorded no device operation at all."""
    import torch

    _, _, _, cuda_kkt, _ = _import_port()
    out = {}
    for where, args in torch.load(path, map_location="cuda").items():
        cuda_kkt.cho_solve(*args)  # the library loads outside the trace
        out[where] = {"shapes": [list(a.shape) for a in args],
                      "strides": [list(a.stride()) for a in args],
                      "ops": device_kernels(lambda: cuda_kkt.cho_solve(*args))}
    with open(path + ".json", "w") as f:
        json.dump(out, f)


def card_plain_factor(path: str) -> None:
    """Child mode: the f64 B=4 penalized case on the card with
    tridiag_factor's plain version in place of its kernel, to read how far
    a change of summation order alone moves sigma."""
    import torch

    torch.set_num_threads(1)
    P, _, _, cuda_kkt, _ = _import_port()
    from successiveconvexification_tpu_torch.ops import precision

    precision.full_precision()
    cuda_kkt.tridiag_factor = cuda_kkt.tridiag_factor_plain
    model, pb, cfg = reference_case(P, "penalized", "cuda")
    t0 = time.perf_counter()
    st = P.solve_batch(model, pb, cfg, device="cuda")
    torch.cuda.synchronize()
    out = {**_reference_summary(st), "seconds": time.perf_counter() - t0}
    with open(path, "w") as f:
        json.dump(out, f)


def _free_port() -> int:
    """A port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _wrappers(cuda_fused, cuda_kkt, cuda_disc) -> dict:
    """Every kernel's wrapper, by the name of its launch counter."""
    return {"fused_factor": cuda_fused.fused_factor,
            "tridiag_solve": cuda_kkt.tridiag_solve,
            "cho_solve_vec": cuda_kkt.cho_solve_vec,
            "chol": cuda_kkt.chol, "cho_solve": cuda_kkt.cho_solve,
            "tridiag_factor": cuda_kkt.tridiag_factor,
            "fused_chol_solve": cuda_kkt.fused_chol_solve,
            "discretize_lanes": cuda_disc.discretize_lanes}


def _same_leaves(a, b) -> tuple:
    """(leaves equal bit for bit, leaves) of two states of one tree."""
    import torch
    from successiveconvexification_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return sum(torch.equal(_bits(x.cpu()), _bits(y.cpu()))
               for x, y in zip(la, lb)), len(lb)


def _pm_case(P, device: str):
    """(model, params batch, cfg) of the point-mass path (phase 2d)."""
    import torch

    cfg = _configs(P, "float32", PM_K, MAIN_SUBSTEPS, bench=True,
                   free_final_time=False, w_sigma=0.0, w_mass=1.0)
    return (P.pointmass3dof_model(),
            _dispersed(P, MAIN_B, torch.float32, device, pointmass=True), cfg)


def sharded_sweep_child(path: str) -> None:
    """Child mode of phase 2h (a): the main path's sweep (the rocket, K=50,
    f32, bench.py's settings, phase 2's 256 dispersions) by ``solve_batch``
    and by ``run_batch`` on an NCCL group of one rank with a commit every
    SHARD_CKPT_EVERY iterations, in this process; launch counters set to 0
    around each run and matched to the IPM's structure, the two final
    states compared leaf by leaf, and the host time of each commit."""
    import torch

    torch.set_num_threads(1)
    P, _, cuda_fused, cuda_kkt, cuda_disc = _import_port()
    from successiveconvexification_tpu_torch.io import checkpoint
    from successiveconvexification_tpu_torch.parallel import batch as batch_mod
    from successiveconvexification_tpu_torch.parallel import mesh as mesh_lib

    wrappers = _wrappers(cuda_fused, cuda_kkt, cuda_disc)
    model = P.rocket6dof_model()
    cfg = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True)
    pb = _dispersed(P, SHARD_B, torch.float32, "cuda")
    ck = os.path.join(ROOT, "build", "chip_smoke_2h_a", "sweep")
    checkpoint.remove_shards(ck, first=0)
    out = {}
    mesh = mesh_lib.init_distributed(f"localhost:{_free_port()}", 1, 0, "cuda")
    try:
        runs = {"solve_batch": lambda: P.solve_batch(model, pb, cfg,
                                                     device="cuda"),
                "run_batch": lambda: batch_mod.run_batch(
                    model, pb, cfg, mesh=mesh, ckpt_path=ck,
                    ckpt_every=SHARD_CKPT_EVERY)}
        commit_s = []
        orig_commit = batch_mod._Committer.__call__

        def timed_commit(self, st, step):
            t0 = time.perf_counter()
            orig_commit(self, st, step)
            commit_s.append(time.perf_counter() - t0)

        batch_mod._Committer.__call__ = timed_commit
        try:
            states = {}
            for name, fn in runs.items():
                states[name], launches, counts = counted(batch_mod, wrappers,
                                                         {}, fn)
                try:
                    check_launches(f"2h (a) {name}", launches, counts,
                                   PER_ITER, PER_COLD)
                    err = None
                except PhaseError as e:
                    err = str(e)
                out[name] = {"wall": counts["wall"],
                             "lockstep": counts["lockstep"],
                             "cold": counts["cold"], "launches": launches,
                             "launch_error": err}
        finally:
            batch_mod._Committer.__call__ = orig_commit
        st = states["run_batch"]
        same, n = _same_leaves(st, states["solve_batch"])
        out.update(same=same, leaves=n, commits=len(commit_s),
                   commit_ms=[1e3 * t for t in commit_s],
                   step=checkpoint.sharded_step(ck, cfg),
                   converged=int(st.converged.sum()), B=SHARD_B,
                   max_iterations=int(st.iterations.max()),
                   finite=all(bool(torch.isfinite(t).all())
                              for t in (st.X, st.U, st.sigma)))
    finally:
        mesh_lib.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)


def pm_run_batch_child(ck: str, mode: str, path: str) -> None:
    """Child mode of phase 2h (b): the point-mass path (phase 2d) under
    ``run_batch`` on an NCCL group of one rank, a commit every
    PM_CKPT_EVERY iterations to ``ck``. ``mode`` crash: the process
    hard-exits right after the step-PM_CRASH_STEP commit lands; resume (or
    full): it resumes from the shard files under ``ck``, if any, and saves
    its final state to ``path`` with the step it started from."""
    import glob

    import numpy as np
    import torch

    torch.set_num_threads(1)
    P, *_ = _import_port()
    from successiveconvexification_tpu_torch.io import checkpoint
    from successiveconvexification_tpu_torch.parallel import batch as batch_mod
    from successiveconvexification_tpu_torch.parallel import mesh as mesh_lib
    from successiveconvexification_tpu_torch.utils.tree import tree_leaves

    if mode == "crash":
        save = checkpoint.save_sharded

        def save_then_exit(path_, state, mesh=None, cfg=None, step=0):
            save(path_, state, mesh=mesh, cfg=cfg, step=step)
            if step == PM_CRASH_STEP:
                os._exit(9)      # an uncoordinated failure mid-sweep

        checkpoint.save_sharded = save_then_exit
    model, pb, cfg = _pm_case(P, "cuda")
    start = (checkpoint.sharded_step(ck, cfg)
             if glob.glob(f"{ck}.shard*.npz") else 0)
    mesh = mesh_lib.init_distributed(f"localhost:{_free_port()}", 1, 0, "cuda")
    try:
        t0 = time.perf_counter()
        st = batch_mod.run_batch(model, pb, cfg, mesh=mesh, ckpt_path=ck,
                                 ckpt_every=PM_CKPT_EVERY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mesh_lib.destroy_process_group()
    np.savez(path, start=start, wall=wall,
             n_converged=int(st.converged.sum()),
             **{str(i): t.cpu().numpy() for i, t in enumerate(tree_leaves(st))})


def sharded_resume_child(path: str) -> None:
    """Child mode of phase 2h (b) and (c). (b): the point-mass path under
    ``run_batch`` uninterrupted, beside the same run in a child that
    crashes right after its step-10 commit; then a fresh child resumes the
    crashed run's shard files, and its final state is compared leaf by
    leaf with the uninterrupted run's. (c): ``cli sweep --distributed`` on
    one rank at the CLI child's size, then the same command again, which
    resumes the finished sweep."""
    import shutil

    import numpy as np

    from successiveconvexification_tpu_torch.io import checkpoint

    work = os.path.join(ROOT, "build", "chip_smoke_2h_bc")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    me = [sys.executable, os.path.abspath(__file__), "--pm-run-batch"]
    ck = {m: os.path.join(work, m, "sweep") for m in ("full", "crash")}
    npz = {m: os.path.join(work, f"{m}.npz") for m in ("full", "resume")}
    logs = {m: open(os.path.join(work, f"{m}.log"), "w")
            for m in ("full", "crash", "resume")}
    out = {}
    try:
        procs = {m: subprocess.Popen(me + [ck[m], m, npz.get(m, "-")],
                                     cwd=ROOT, stdout=logs[m],
                                     stderr=subprocess.STDOUT)
                 for m in ("full", "crash")}
        try:
            rcs = {m: p.wait(timeout=600) for m, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out["rc"] = rcs
        out["crash_step"] = checkpoint.sharded_step(ck["crash"])
        rcs["resume"] = subprocess.run(
            me + [ck["crash"], "resume", npz["resume"]], cwd=ROOT,
            stdout=logs["resume"], stderr=subprocess.STDOUT,
            timeout=600).returncode
        if rcs["full"] == 0 and rcs["resume"] == 0:
            with np.load(npz["full"]) as a, np.load(npz["resume"]) as b:
                keys = [k for k in a.files if k.isdigit()]
                out["same"] = sum(a[k].tobytes() == b[k].tobytes()
                                  for k in keys)
                out["leaves"] = len(keys)
                out["resume_start"] = int(b["start"])
                out["walls"] = {"full": float(a["wall"]),
                                "resume": float(b["wall"])}
                out["converged"] = int(a["n_converged"])
        # (c) the CLI twice on one rank: the second run resumes the
        # finished sweep
        cli_ck = os.path.join(work, "cli", "sweep")
        recs = []
        for i in range(2):
            cmd = [sys.executable, "-m",
                   "successiveconvexification_tpu_torch.cli", "sweep",
                   "--distributed", "--num-processes", "1", "--process-id",
                   "0", "--coordinator", f"localhost:{_free_port()}",
                   "--checkpoint", cli_ck, "--ckpt-every",
                   str(CLI_CKPT_EVERY), "--batch", "8", f"--disc.K={ATMO_K}"]
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            with open(os.path.join(work, f"cli{i}.log"), "w") as f:
                f.write(r.stdout + r.stderr)
            out.setdefault("cli_rc", []).append(r.returncode)
            if r.returncode == 0:
                recs.append(json.loads(r.stdout[r.stdout.index("{"):
                                                r.stdout.rindex("}") + 1]))
        out["cli"] = recs
        out["cli_step"] = checkpoint.sharded_step(cli_ck)
    finally:
        for f in logs.values():
            f.close()
    with open(path, "w") as f:
        json.dump(out, f)


def _ksharded_subproblem(P, device: str, penalized: bool = False):
    """(StageSOCP, cfg) of the JAX package's ksharded reference test
    (tests/test_parallel.py:147-189): the rocket at K=50, 3 substeps, f64,
    IPM cap 45 with one refinement step, the first subproblem from
    ``scvx_init``; on ``device``. ``penalized``: the penalized path's model
    (``penalized_model``, w_dir_penalty PENALTY_W), whose subproblem has
    rank-one rows."""
    import torch
    from successiveconvexification_tpu_torch.models import rocket6dof as rk
    from successiveconvexification_tpu_torch.ops import discretize, socp

    cfg = P.SolverConfig(dtype="float64",
                         disc=P.DiscretizationConfig(K=MAIN_K, substeps=3),
                         ipm=P.IPMConfig(max_iters=45, refine_steps=1))
    model = P.rocket6dof_model()
    if penalized:
        cfg = dataclasses.replace(cfg, scvx=dataclasses.replace(
            cfg.scvx, w_dir_penalty=PENALTY_W))
        model = penalized_model(P)
    p = rk.default_params(torch.float64, device).map(lambda v, tail: v[None])
    st = P.scvx_init(model, p, cfg)
    d = socp.assemble(model, cfg.scvx, p, discretize.discretize(
        model, p, st.X, st.U, st.sigma, cfg.disc.substeps), st.X, st.U,
        st.sigma, st.tr_radius, True, st.penalty_scale)
    return d, cfg


def ksharded_child(path: str) -> None:
    """Child mode of phase 2i, the ksharded KKT backend on an NCCL group of
    one rank: (a) the JAX reference test's subproblem solved on the card
    with ksharded and with scan, and with ksharded on the CPU (a mesh of
    the CPU, the plain versions); (b) ``scvx_solve`` of the nominal rocket
    with ksharded at the main path's settings, launch counters set to 0
    around it (c); (d) tridiag_factor and tridiag_solve held to their plain
    versions (``check_call``) on (b)'s calls: the first of its first IPM
    iteration and every third of SCvx iteration LATE_LOCKSTEP (the
    interior chain, the folded columns, the reduced system at N = 1)."""
    import torch

    torch.set_num_threads(1)
    P, _, cuda_fused, cuda_kkt, cuda_disc = _import_port()
    from successiveconvexification_tpu_torch.models import rocket6dof as rk
    from successiveconvexification_tpu_torch.ops import ipm
    from successiveconvexification_tpu_torch.parallel import batch as batch_mod
    from successiveconvexification_tpu_torch.parallel import kkt_sharded as ks
    from successiveconvexification_tpu_torch.parallel import mesh as mesh_lib

    wrappers = _wrappers(cuda_fused, cuda_kkt, cuda_disc)
    out = {}
    mesh = mesh_lib.init_distributed(f"localhost:{_free_port()}", 1, 0, "cuda")
    try:
        # (a)
        sols = {}
        for where, kkt in (("card", "ksharded"), ("card", "scan"),
                           ("cpu", "ksharded")):
            d, cfg = _ksharded_subproblem(P, "cuda" if where == "card"
                                          else "cpu")
            ks.set_kkt_mesh(mesh if where == "card"
                            else mesh_lib.make_mesh("cpu"))
            t0 = time.perf_counter()
            sol = ipm.ipm_solve(d, dataclasses.replace(cfg.ipm,
                                                       kkt_solver=kkt))
            if where == "card":
                torch.cuda.synchronize()
            sols[where, kkt] = sol
            out[f"a_{where}_{kkt}"] = {
                "converged": bool(sol.converged[0]),
                "iters": int(sol.iters[0]), "sig": float(sol.x.sig[0]),
                "seconds": time.perf_counter() - t0}
        ks.set_kkt_mesh(mesh)
        ref = sols["card", "ksharded"]
        for where, kkt in (("card", "scan"), ("cpu", "ksharded")):
            o = sols[where, kkt]
            out[f"a_{where}_{kkt}"].update(
                w_diff=float((ref.x.w.cpu() - o.x.w.cpu()).abs().max()),
                sig_diff=abs(float(ref.x.sig[0]) - float(o.x.sig[0])))
        # (e) the same subproblem with GONDZIO correctors an iteration on the
        # card, ksharded (launches counted) and scan
        e = {}
        for kkt in ("ksharded", "scan"):
            d, cfg = _ksharded_subproblem(P, "cuda")
            icfg = dataclasses.replace(cfg.ipm, kkt_solver=kkt,
                                       gondzio_correctors=GONDZIO)
            sol, launches, counts = counted(
                batch_mod, wrappers, {}, lambda: ipm.ipm_solve(d, icfg))
            sols["card_g", kkt] = sol
            e[kkt] = {"converged": bool(sol.converged[0]),
                      "iters": int(sol.iters[0]), "sig": float(sol.x.sig[0]),
                      "seconds": counts["wall"], "launches": launches,
                      "launch_error": _launch_error(
                          f"2i (e) {kkt}", launches, dict(counts, cold=1),
                          per_iter(kkt, GONDZIO), PER_COLD_OF[kkt])}
        g_ks, g_scan = sols["card_g", "ksharded"], sols["card_g", "scan"]
        e.update(w_diff=float((g_ks.x.w - g_scan.x.w).abs().max()),
                 sig_diff=abs(float(g_ks.x.sig[0]) - float(g_scan.x.sig[0])),
                 w_diff_g0=float((g_ks.x.w - ref.x.w).abs().max()))
        out["e"] = e
        # (b) and (c)
        model = P.rocket6dof_model()
        cfg = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True,
                       kkt="ksharded")
        caps = {name: Capture(cuda_kkt, name, KSHARDED_PER_COLD[name])
                for name in ("tridiag_factor", "tridiag_solve")}
        st, launches, counts = counted(
            batch_mod, wrappers, caps, lambda: P.scvx_solve(
                model, rk.default_params(torch.float32, "cuda"), cfg,
                device="cuda"))
        try:
            check_launches("2i (b) ksharded scvx_solve", launches, counts,
                           KSHARDED_PER_ITER, KSHARDED_PER_COLD)
            err = None
        except PhaseError as e:
            err = str(e)
        out["b"] = {"converged": bool(st.converged[0]),
                    "iterations": int(st.iterations[0]),
                    "sigma": float(st.sigma[0]), "wall": counts["wall"],
                    "lockstep": counts["lockstep"], "cold": counts["cold"],
                    "launches": launches, "launch_error": err,
                    "finite": all(bool(torch.isfinite(t).all())
                                  for t in (st.X, st.U, st.sigma))}
        # (d); a matrix right-hand side's nrx columns are folded into lanes
        out["nrx"] = caps["tridiag_factor"].first[0].shape[-1]
        plains = {"tridiag_factor": cuda_kkt.tridiag_factor_plain,
                  "tridiag_solve": cuda_kkt.tridiag_solve_plain}
        checks = []
        for name, cap in caps.items():
            calls = [("first IPM iteration", cap.first)]
            calls += [(f"SCvx iteration {LATE_LOCKSTEP}, call {i}", a)
                      for i, a in enumerate(cap.late) if i % 3 == 0]
            for when, a in calls:
                res = check_call(name, a, wrappers[name], plains[name])
                checks.append({"name": name, "when": when,
                               "shapes": [list(t.shape) for t in a], **res})
        out["d"] = checks
    finally:
        ks.set_kkt_mesh(None)
        mesh_lib.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)


def gondzio_host_child(path: str, main_state: str) -> None:
    """Child mode of phase 2j. (a) The phase-2i reference subproblem solved
    on the card on the fused ``scan``, on ``pcr`` and, with the penalized
    path's model, on the unfused ``scan``, each at 0 and at GONDZIO
    correctors an iteration (launches counted around each), and on the CPU
    at GONDZIO; (b) ``scvx_solve`` of the nominal rocket at the main path's
    settings with GONDZIO correctors on the fused route; (c) the main
    path's sweep under ``solve_batch_compact`` (host compaction, chunk 10,
    min bucket 32), its final state compared leaf by leaf with phase 2's
    (``main_state``, saved by the parent) and each chunk's host round trip
    timed."""
    import torch

    torch.set_num_threads(1)
    P, _, cuda_fused, cuda_kkt, cuda_disc = _import_port()
    from successiveconvexification_tpu_torch.models import rocket6dof as rk
    from successiveconvexification_tpu_torch.ops import ipm
    from successiveconvexification_tpu_torch.parallel import batch as batch_mod

    wrappers = _wrappers(cuda_fused, cuda_kkt, cuda_disc)
    out = {"a": {}}
    # (a)
    for route, kkt in (("scan", "scan"), ("pcr", "pcr"),
                       ("penalized", "scan")):
        sols, rec = {}, {}
        for where, g in (("card", 0), ("card", GONDZIO), ("cpu", GONDZIO)):
            d, cfg = _ksharded_subproblem(P, "cuda" if where == "card"
                                          else "cpu", route == "penalized")
            icfg = dataclasses.replace(cfg.ipm, kkt_solver=kkt,
                                       gondzio_correctors=g)
            sol, launches, counts = counted(
                batch_mod, wrappers, {}, lambda: ipm.ipm_solve(d, icfg))
            key = f"{where}_g{g}"
            sols[key] = sol
            rec[key] = {"converged": bool(sol.converged[0]),
                        "iters": int(sol.iters[0]),
                        "sig": float(sol.x.sig[0]),
                        "seconds": counts["wall"]}
            if where == "card":
                rec[key].update(launches=launches,
                                launch_error=_launch_error(
                                    f"2j (a) {route} g={g}", launches,
                                    dict(counts, cold=1), per_iter(route, g),
                                    PER_COLD_OF[route]))
        g2, g0, cpu = (sols[f"card_g{GONDZIO}"], sols["card_g0"],
                       sols[f"cpu_g{GONDZIO}"])
        rec.update(
            w_diff_g0=float((g2.x.w - g0.x.w).abs().max()),
            w_diff_cpu=float((g2.x.w.cpu() - cpu.x.w).abs().max()),
            sig_diff_cpu=abs(float(g2.x.sig[0]) - float(cpu.x.sig[0])))
        out["a"][route] = rec
    # (b)
    model = P.rocket6dof_model()
    cfg = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True)
    cfg_g = dataclasses.replace(cfg, ipm=dataclasses.replace(
        cfg.ipm, gondzio_correctors=GONDZIO))
    st, launches, counts = counted(
        batch_mod, wrappers, {}, lambda: P.scvx_solve(
            model, rk.default_params(torch.float32, "cuda"), cfg_g,
            device="cuda"))
    out["b"] = {"converged": bool(st.converged[0]),
                "iterations": int(st.iterations[0]),
                "sigma": float(st.sigma[0]), "wall": counts["wall"],
                "lockstep": counts["lockstep"], "cold": counts["cold"],
                "ipm_iterations": launches["fused_factor"] - counts["cold"],
                "launches": launches,
                "launch_error": _launch_error(
                    "2j (b)", launches, counts, per_iter("scan", GONDZIO),
                    PER_COLD),
                "finite": all(bool(torch.isfinite(t).all())
                              for t in (st.X, st.U, st.sigma))}
    # (c)
    pb = _dispersed(P, MAIN_B, torch.float32, "cuda")
    marks = []
    orig_chunk = batch_mod._solve_chunk

    def timed_chunk(model_, pb_, cfg_, chunk, st_, mesh=None):
        t0 = time.perf_counter()
        res = orig_chunk(model_, pb_, cfg_, chunk, st_, mesh)
        torch.cuda.synchronize()
        marks.append((t0, time.perf_counter(), pb_.batch_shape[0]))
        return res

    def host_sweep():
        res = P.solve_batch_compact(model, pb, cfg, chunk=10, min_bucket=32,
                                    device="cuda")
        marks.append((time.perf_counter(), None, None))
        return res

    batch_mod._solve_chunk = timed_chunk
    try:
        st, launches, counts = counted(batch_mod, wrappers, {}, host_sweep)
    finally:
        batch_mod._solve_chunk = orig_chunk
    trips = [1e3 * (b[0] - a[1]) for a, b in zip(marks[:-2], marks[1:-1])]
    sizes = [m[2] for m in marks[:-1]]
    main = torch.load(main_state)
    same, n = _same_leaves(st, main)
    out["c"] = {"wall": counts["wall"], "lockstep": counts["lockstep"],
                "cold": counts["cold"], "launches": launches,
                "launch_error": _launch_error("2j (c)", launches, counts,
                                              PER_ITER, PER_COLD),
                "chunks": len(sizes), "sizes": sizes,
                "repacks": sum(b < a for a, b in zip(sizes, sizes[1:])),
                "trip_ms": trips,
                "last_trip_ms": 1e3 * (marks[-1][0] - marks[-2][1]),
                "same": same, "leaves": n,
                "converged": int(st.converged.sum()),
                "max_iterations": int(st.iterations.max()),
                "finite": all(bool(torch.isfinite(t).all())
                              for t in (st.X, st.U, st.sigma))}
    with open(path, "w") as f:
        json.dump(out, f)


def _reference_summary(st) -> dict:
    return {"sigma": st.sigma.tolist(), "iterations": st.iterations.tolist(),
            "converged": st.converged.tolist(), "X": st.X.tolist(),
            "U": st.U.tolist()}


# ---------------------------------------------------------------- helpers
class Capture:
    """Wrap a kernel wrapper to keep (by reference) the inputs of one chosen
    call and of the recent calls; ``late`` is set from those by the caller.
    The wrapped function is the original, so its launch counter is
    untouched by the wrapping."""

    def __init__(self, module, name: str, first_index: int):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.first_index = first_index
        self.calls = 0
        self.first = None
        # more than one SCvx iteration's calls (a cold init and 15 IPM
        # iterations launch at most 16, 63 and 94 of the three kernels)
        self.recent = collections.deque(maxlen=256)
        self.late = None

    # the wrapper increments its counter through its module-level name,
    # which is this object while the capture is installed
    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, value):
        self.orig.launches = value

    def __call__(self, *args):
        if self.calls == self.first_index:
            self.first = args
        self.recent.append(args)
        self.calls += 1
        return self.orig(*args)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _lanes(t):
    """(B, rest) float64 view; axis 0 is the scenario lane."""
    return t.double().reshape(t.shape[0], -1)


def _lane_finite(outs):
    """(B,) bool: every output of the call is finite in the lane."""
    import torch

    return torch.stack([torch.isfinite(_lanes(o)).all(1) for o in outs]).all(0)


# Backward-error gate. A backward-stable factorization or solve reproduces
# its inputs to within a few roundoffs per term, whatever the conditioning
# (Higham, Accuracy and Stability of Numerical Algorithms, ch. 3, 8, 10):
# the componentwise residual |res| / (sum of the absolute values of the
# terms) is at most gamma_N = N u / (1 - N u), u = eps / 2, N the longest
# chain of terms. Each gate below is 2 gamma_N: the kernel's own rounding
# plus that of evaluating the residual in float64. The residuals are
# computed from the kernel's outputs and inputs only; no reference
# implementation enters.
#
# Forward-error gate against the float64 plain version. Its tolerance is
# the forward error that those backward-error bounds permit, computed per
# entry on the float64 reference, with no fitted factor:
#   - a solve with residual r has x - x* = A^-1 r exactly, so
#     |x - x_ref| <= |A^-1| (gamma_k den(x) + gamma_64 den(x_ref)) (Skeel);
#   - a Cholesky factor of A + dA moves, to first order, by
#     L Phi(L^-1 dA L^-T) (Phi: lower triangle, half the diagonal), so
#     |dL| <= |L| Phi(|L^-1| |dA| |L^-T|); the bound is doubled to cover
#     the higher-order terms, which is enough where ||A^-1|| ||dA|| <= 1/2,
#     and the factors are held only in lanes certified so (below).
#
# Finiteness gate. Near the end of an IPM, float32 Cholesky factorizations
# break down (a pivot <= 0, NaN) in many lanes, and which lanes break down
# depends on the order of rounding: two correct implementations disagree
# there. So a kernel must be finite in every lane where success in its
# dtype is GUARANTEED: where the matrix it factors stays positive definite,
# with room for the forward bound, under every perturbation within its
# backward-error bound: lambda_min(A) > 2 ||dA||_2 (Weyl), with ||dA||_2 at
# most gamma_N x the largest row sum of the absolute-term scales; checked
# by a float64 Cholesky of A - 2 gamma_N x (that row sum) x I.
def _gamma(n: int, dtype) -> float:
    import torch

    u = torch.finfo(dtype).eps / 2
    return n * u / (1 - n * u)


def _both(n: int, dtype) -> float:
    """The rounding of the kernel in its dtype plus that of the float64
    reference."""
    import torch

    return _gamma(n, dtype) + _gamma(n, torch.float64)


def _omega(res, den):
    """(B,) max over each lane of |res| / den (a nonzero over 0 is huge)."""
    return _lanes((res.abs() / den.clamp(min=1e-300))).amax(1)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _T(A):
    return A.transpose(-1, -2)


def _eye(n, like):
    import torch

    return torch.eye(n, dtype=like.dtype, device=like.device)


def _chol_forward(Lr, dA):
    """Bound on |L - Lr| for the Cholesky factor of A + dA, |dA| <= dA."""
    import torch

    Li = torch.linalg.solve_triangular(Lr, _eye(Lr.shape[-1], Lr), upper=False)
    X = Li.abs() @ dA @ _T(Li.abs())
    phi = torch.tril(X, -1) + 0.5 * torch.diag_embed(X.diagonal(0, -2, -1))
    return 2 * Lr.abs() @ phi


def _dense(diag, lower, sym):
    """(B, N n, N n) from diagonal blocks (B, N, n, n) and the blocks below
    them, lower[:, k] at block (k + 1, k); mirrored above when ``sym``."""
    import torch

    B, N, n, _ = diag.shape
    out = torch.zeros(B, N * n, N * n, dtype=diag.dtype, device=diag.device)
    for k in range(N):
        out[:, k * n:(k + 1) * n, k * n:(k + 1) * n] = diag[:, k]
        if k + 1 < N:
            out[:, (k + 1) * n:(k + 2) * n, k * n:(k + 1) * n] = lower[:, k]
            if sym:
                out[:, k * n:(k + 1) * n, (k + 1) * n:(k + 2) * n] = _T(lower[:, k])
    return out


def _blocks(X, N, n):
    """Diagonal blocks and the blocks below them of a dense (B, N n, N n)."""
    import torch

    d = torch.stack([X[:, k * n:(k + 1) * n, k * n:(k + 1) * n]
                     for k in range(N)], 1)
    low = (torch.stack([X[:, (k + 1) * n:(k + 2) * n, k * n:(k + 1) * n]
                        for k in range(N - 1)], 1) if N > 1
           else X.new_zeros((X.shape[0], 0, n, n)))
    return d, low


def _as_cols(L, b):
    """A vector right-hand side (..., n) as one column (..., n, 1)."""
    return b[..., None] if b.dim() == L.dim() - 1 else b


def _cho_den(args, x):
    """Residual of (L L') X = B (column by column) and its absolute-term
    scale; vector or matrix right-hand sides, returned as columns."""
    L, b = (t.double() for t in args)
    b, x = _as_cols(L, b), _as_cols(L, x.double())
    return (L @ (_T(L) @ x) - b,
            L.abs() @ (_T(L).abs() @ x.abs()) + b.abs())


def _backward_cho(args, outs):
    """Two triangular solves of n terms a row, evaluated with 2n + 1."""
    res, den = _cho_den(args, outs[0])
    return {"solve": (_omega(res, den), 2 * args[0].shape[-1] + 1)}


def _forward_cho(args, ref, outs, dtype):
    import torch

    L = args[0].double()
    n_t = 2 * L.shape[-1] + 1
    Ainv = torch.cholesky_inverse(L).abs()
    tol = Ainv @ (_gamma(n_t, dtype) * _cho_den(args, outs[0])[1]
                  + _gamma(n_t, torch.float64) * _cho_den(args, ref[0])[1])
    err = _as_cols(L, outs[0].double()) - _as_cols(L, ref[0].double())
    return _omega(err, tol)


# chol: Higham Thm 10.3, the computed factor of an n x n SPD A satisfies
# L L' = A + dA with |dA| <= gamma_{n+1} |L| |L'|. Only the lower triangle
# of A is read (the IPM's H is symmetric only to rounding).
def _backward_chol(args, outs):
    import torch

    A, L = args[0].double(), outs[0].double()
    res = torch.tril(L @ _T(L) - A)
    return {"factor": (_omega(res, L.abs() @ _T(L.abs())), A.shape[-1] + 1)}


def _forward_chol(args, ref, outs, dtype):
    Lr = ref[0].double()
    tol = _chol_forward(Lr, _both(Lr.shape[-1] + 1, dtype)
                        * (Lr.abs() @ _T(Lr.abs())))
    return _omega(outs[0].double() - Lr, tol)


def _guaranteed_chol(args, ref, dtype):
    """(N,) blocks that stay positive definite, with room for the forward
    bound, under every perturbation within the backward-error bound."""
    from successiveconvexification_tpu_torch.ops import smallla

    A, Lr = args[0].double(), ref[0].double()
    shift = 2 * _gamma(A.shape[-1] + 1, dtype) * (
        Lr.abs() @ _T(Lr.abs())).sum(-1).amax(-1)
    return _lane_finite((smallla.chol(A - shift[..., None, None]
                                      * _eye(A.shape[-1], A)),))


def _tridiag_den(args, u):
    """Residual of M u = r, M = Lb Lb' with Lb block lower bidiagonal (L_k
    on the diagonal, C_k' below it), and its absolute-term scale."""
    L, C, r = (t.double() for t in args)
    u = u.double()
    w, wa = _mv(_T(L), u), _mv(_T(L).abs(), u.abs())
    w[:, :-1] += _mv(C[:, 1:], u[:, 1:])
    wa[:, :-1] += _mv(C[:, 1:].abs(), u[:, 1:].abs())
    y, ya = _mv(L, w), _mv(L.abs(), wa)
    y[:, 1:] += _mv(_T(C[:, 1:]), w[:, :-1])
    ya[:, 1:] += _mv(_T(C[:, 1:]).abs(), wa[:, :-1])
    return y - r, ya + r.abs()


def _backward_tridiag(args, outs):
    """Each sweep's row has 2n terms; the evaluation 4n + 1."""
    res, den = _tridiag_den(args, outs[0])
    return {"solve": (_omega(res, den), 4 * args[0].shape[-1] + 1)}


def _forward_tridiag(args, ref, outs, dtype):
    import torch

    L, C = args[0].double(), args[1].double()
    B, N, n, _ = L.shape
    n_t = 4 * n + 1
    Lb = _dense(L, _T(C[:, 1:]), sym=False)
    Li = torch.linalg.solve_triangular(Lb, _eye(N * n, Lb), upper=False)
    Ainv = (_T(Li) @ Li).abs()
    den = (_gamma(n_t, dtype) * _tridiag_den(args, outs[0])[1]
           + _gamma(n_t, torch.float64) * _tridiag_den(args, ref[0])[1])
    tol = _mv(Ainv, den.reshape(B, N * n))
    return _omega((outs[0].double() - ref[0].double()).reshape(B, N * n), tol)


def _fused_terms(args, Lh):
    """What the fused factorization factors, formed in float64 from its
    inputs and a given chol_Hw, each beside the sum of the absolute values
    of its terms (the scale of the rounding any method commits on it).

    H_k: the kernel sums R + S + 1 terms, each with a factor u_s of up to m
    terms, then factors: N_h = R + S + 2m + 3. D_k, O_k: formed with X =
    H^-1 E', H^-1 F' solved from chol_Hw; a backward-stable solve has
    (H + dH) X = E', |dH| <= 2 gamma_nw |chol_Hw| |chol_Hw'|, so E X carries
    an error up to |X|' |dH| |X|, which joins the absolute terms of D and O
    (first order in u). With the block-tridiagonal step,
    N_s = 2 nw + 2 nrx + 3. Da_h, Oa_h carry H's own rounding (|dH| up to
    gamma_{N_h} |H's terms|) into D and O, for the forward bound."""
    import torch

    from successiveconvexification_tpu_torch.ops import smallla

    G, wrow, uv, ucoef, hdiag, E, F, dpq = (t.double() for t in args[:8])
    rng = args[8].tolist()
    Lh = Lh.double()
    nw, nrx, R = G.shape[-1], E.shape[-2], G.shape[-2]
    Ga = G.abs()
    H = torch.einsum("bkr,bkra,bkrc->bkac", wrow, G, G)
    Ha = torch.einsum("bkr,bkra,bkrc->bkac", wrow.abs(), Ga, Ga)
    m = 0
    for s, (o, e) in enumerate(rng):
        u = torch.einsum("bkr,bkra->bka", uv[..., o:e], G[..., o:e, :])
        ua = torch.einsum("bkr,bkra->bka", uv[..., o:e].abs(), Ga[..., o:e, :])
        H += ucoef[..., s, None, None] * u[..., :, None] * u[..., None, :]
        Ha += ucoef[..., s, None, None].abs() * ua[..., :, None] * ua[..., None, :]
        m = max(m, e - o)
    H += torch.diag_embed(hdiag)
    Ha += torch.diag_embed(hdiag.abs())
    HH = Lh.abs() @ _T(Lh.abs())
    XE = smallla.cho_solve(Lh[:, :-1], _T(E))       # H_k^-1 E_k'
    XF = smallla.cho_solve(Lh[:, 1:], _T(F))        # H_{k+1}^-1 F_k'
    XEa, XFa = XE.abs(), XF.abs()
    return dict(
        H=H, Ha=Ha, HH=HH,
        D=E @ XE + F @ XF + torch.diag_embed(dpq),
        Da=(E.abs() @ XEa + F.abs() @ XFa + torch.diag_embed(dpq.abs())
            + _T(XEa) @ HH[:, :-1] @ XEa + _T(XFa) @ HH[:, 1:] @ XFa),
        Da_h=_T(XEa) @ Ha[:, :-1] @ XEa + _T(XFa) @ Ha[:, 1:] @ XFa,
        O=F[:, :-1] @ XE[:, 1:],                   # O_k = F_k H_{k+1}^-1 E_{k+1}'
        Oa=(F[:, :-1].abs() @ XEa[:, 1:]
            + _T(XFa[:, :-1]) @ HH[:, 1:-1] @ XEa[:, 1:]),
        Oa_h=_T(XFa[:, :-1]) @ Ha[:, 1:-1] @ XEa[:, 1:],
        n_h=R + len(rng) + 2 * m + 3, n_s=2 * nw + 2 * nrx + 3)


def _schur_den(t, L, C, with_h=False):
    """Absolute-term scales of the block-tridiagonal system rebuilt from
    (L, C): D_k = L_k L_k' + C_k' C_k, O_k = L_k C_{k+1}."""
    den_d = L.abs() @ _T(L.abs()) + _T(C.abs()) @ C.abs() + t["Da"]
    den_o = L[:, :-1].abs() @ C[:, 1:].abs() + t["Oa"]
    if with_h:
        den_d, den_o = den_d + t["Da_h"], den_o + t["Oa_h"]
    return den_d, den_o


def _backward_fused(args, outs):
    """'hessian': chol_Hw chol_Hw' - H over |chol_Hw| |chol_Hw'| + |H's
    terms|; 'schur': the block-tridiagonal system rebuilt from the kernel's
    L, C against D, O formed from the kernel's OWN chol_Hw (_fused_terms)."""
    import torch

    Lh, L, C = (t.double() for t in outs)
    t = _fused_terms(args, Lh)
    om_h = _omega(Lh @ _T(Lh) - t["H"], t["HH"] + t["Ha"])
    den_d, den_o = _schur_den(t, L, C)
    om_s = _omega(L @ _T(L) + _T(C) @ C - t["D"], den_d)
    if t["O"].shape[1] > 0:
        om_s = torch.maximum(om_s, _omega(L[:, :-1] @ C[:, 1:] - t["O"], den_o))
    return {"hessian": (om_h, t["n_h"]), "schur": (om_s, t["n_s"])}


def _forward_fused(args, ref, outs, dtype):
    """chol_Hw moves with H's rounding; (L, C), the block Cholesky factor
    of the Schur system, with the Schur system's rounding and H's carried
    into D and O (N_h + N_s terms)."""
    import torch

    Lh_r, L_r, C_r = (t.double() for t in ref)
    Lh, L, C = (t.double() for t in outs)
    B, N, n, _ = L_r.shape
    t = _fused_terms(args, Lh_r)
    tol_h = _chol_forward(Lh_r, _both(t["n_h"], dtype) * (t["HH"] + t["Ha"]))
    den_d, den_o = _schur_den(t, L_r, C_r, with_h=True)
    tol = _chol_forward(_dense(L_r, _T(C_r[:, 1:]), sym=False),
                        _both(t["n_h"] + t["n_s"], dtype)
                        * _dense(den_d, _T(den_o), sym=True))
    tol_L, tol_Ct = _blocks(tol, N, n)
    tol_C = torch.cat([torch.zeros_like(tol_L[:, :1]), _T(tol_Ct)], 1)
    return torch.stack([_omega(Lh - Lh_r, tol_h), _omega(L - L_r, tol_L),
                        _omega(C - C_r, tol_C)]).amax(0)


def _guaranteed_fused(args, ref, dtype):
    """(B,) success with room for the forward bound, for every H_k and for
    the Schur system, in ``dtype``."""
    from successiveconvexification_tpu_torch.ops import smallla

    Lh, L, C = (t.double() for t in ref)
    t = _fused_terms(args, Lh)
    nw, nrx = Lh.shape[-1], L.shape[-1]
    shift_h = 2 * _gamma(t["n_h"], dtype) * (t["HH"] + t["Ha"]).sum(-1).amax(-1)
    ok_h = _lane_finite((smallla.chol(t["H"] - shift_h[..., None, None] * _eye(nw, Lh)),))
    den_d, den_o = _schur_den(t, L, C, with_h=True)
    rows = den_d.sum(-1)
    rows[:, :-1] += den_o.sum(-1)
    rows[:, 1:] += den_o.sum(-2)
    shift_s = 2 * _gamma(t["n_h"] + t["n_s"], dtype) * rows.amax((1, 2))
    Ls, _ = smallla.blocktridiag_factor(
        t["D"] - shift_s[:, None, None, None] * _eye(nrx, Lh), t["O"])
    return ok_h & _lane_finite((Ls,))


def _guaranteed_solve(args, ref, dtype):
    """(B,) the solves divide only by the diagonal of L: finite inputs and a
    finite reference give a finite result."""
    return _lane_finite([a for a in args if a.is_floating_point()]) & _lane_finite(ref)


# tridiag_factor: the block Cholesky of M (D_k on the diagonal, O_k above
# it) satisfies L_k L_k' + C_k' C_k = D_k and L_{k-1} C_k = O_{k-1}. Each
# entry of the first sums n terms of C'C, the subtraction from D and n + 1
# of the Cholesky step: N_t = 2n + 2 covers both relations. The residuals
# are taken against the kernel's own L and C; the forward bound is the
# block Cholesky perturbation of the dense factor, as for the fused factor.
def _trifac_den(args, L, C):
    """Absolute-term scales of the two relations."""
    D, O = (t.double() for t in args)
    return (L.abs() @ _T(L.abs()) + _T(C.abs()) @ C.abs() + D.abs(),
            L[:, :-1].abs() @ C[:, 1:].abs() + O.abs())


def _backward_trifac(args, outs):
    import torch

    D, O = (t.double() for t in args)
    L, C = (t.double() for t in outs)
    den_d, den_o = _trifac_den(args, L, C)
    om = _omega(torch.tril(L @ _T(L) + _T(C) @ C - D), den_d)
    if O.shape[1] > 0:
        om = torch.maximum(om, _omega(L[:, :-1] @ C[:, 1:] - O, den_o))
    return {"factor": (om, 2 * D.shape[-1] + 2)}


def _forward_trifac(args, ref, outs, dtype):
    import torch

    L_r, C_r = (t.double() for t in ref)
    L, C = (t.double() for t in outs)
    B, N, n, _ = L_r.shape
    den_d, den_o = _trifac_den(args, L_r, C_r)
    tol = _chol_forward(_dense(L_r, _T(C_r[:, 1:]), sym=False),
                        _both(2 * n + 2, dtype)
                        * _dense(den_d, _T(den_o), sym=True))
    tol_L, tol_Ct = _blocks(tol, N, n)
    tol_C = torch.cat([torch.zeros_like(tol_L[:, :1]), _T(tol_Ct)], 1)
    return torch.maximum(_omega(L - L_r, tol_L), _omega(C - C_r, tol_C))


def _guaranteed_trifac(args, ref, dtype):
    """(B,) the whole system stays positive definite, with room for the
    forward bound, under every perturbation within the backward bound."""
    from successiveconvexification_tpu_torch.ops import smallla

    D, O = (t.double() for t in args)
    L, C = (t.double() for t in ref)
    n = D.shape[-1]
    den_d, den_o = _trifac_den(args, L, C)
    rows = den_d.sum(-1)
    rows[:, :-1] += den_o.sum(-1)
    rows[:, 1:] += den_o.sum(-2)
    shift = 2 * _gamma(2 * n + 2, dtype) * rows.amax((1, 2))
    Ls, _ = smallla.blocktridiag_factor(
        D - shift[:, None, None, None] * _eye(n, D), O)
    return _lane_finite((Ls,))


# fused_chol_solve: Cholesky then two triangular solves, backward stable as
# a whole (Higham Thm 10.4): (A + dA) x = b with |dA| <= gamma_{3n+1}
# |L| |L'|, and for SPD A, (|L| |L'|)_ij <= sqrt(a_ii a_jj) (Cauchy-Schwarz
# on L's rows), so the residual's scale comes from A's diagonal alone.
def _fcs_den(args, x):
    A, b = (t.double() for t in args)
    x = x.double()
    d = A.diagonal(0, -2, -1).clamp(min=0).sqrt()
    return A @ x - b, (d[..., :, None] * d[..., None, :]) @ x.abs() + b.abs()


def _backward_fcs(args, outs):
    res, den = _fcs_den(args, outs[0])
    return {"solve": (_omega(res, den), 3 * args[0].shape[-1] + 2)}


def _forward_fcs(args, ref, outs, dtype):
    import torch

    from successiveconvexification_tpu_torch.ops import smallla

    A = args[0].double()
    n_t = 3 * A.shape[-1] + 2
    Ainv = torch.cholesky_inverse(smallla.chol(A)).abs()
    tol = Ainv @ (_gamma(n_t, dtype) * _fcs_den(args, outs[0])[1]
                  + _gamma(n_t, torch.float64) * _fcs_den(args, ref[0])[1])
    return _omega(outs[0].double() - ref[0].double(), tol)


def _guaranteed_fcs(args, ref, dtype):
    """(N,) A stays positive definite under every perturbation within the
    backward bound, and inputs and reference are finite."""
    from successiveconvexification_tpu_torch.ops import smallla

    A = args[0].double()
    n = A.shape[-1]
    d = A.diagonal(0, -2, -1).clamp(min=0).sqrt()
    shift = 2 * _gamma(3 * n + 2, dtype) * (d * d.sum(-1, keepdim=True)).amax(-1)
    ok = _lane_finite((smallla.chol(A - shift[..., None, None] * _eye(n, A)),))
    return ok & _guaranteed_solve(args, ref, dtype)


BACKWARD = {"fused_factor": _backward_fused, "tridiag_solve": _backward_tridiag,
            "cho_solve_vec": _backward_cho, "chol": _backward_chol,
            "cho_solve": _backward_cho, "tridiag_factor": _backward_trifac,
            "fused_chol_solve": _backward_fcs}
FORWARD = {"fused_factor": _forward_fused, "tridiag_solve": _forward_tridiag,
           "cho_solve_vec": _forward_cho, "chol": _forward_chol,
           "cho_solve": _forward_cho, "tridiag_factor": _forward_trifac,
           "fused_chol_solve": _forward_fcs}
GUARANTEED = {"fused_factor": _guaranteed_fused,
              "tridiag_solve": _guaranteed_solve,
              "cho_solve_vec": _guaranteed_solve, "chol": _guaranteed_chol,
              "cho_solve": _guaranteed_solve,
              "tridiag_factor": _guaranteed_trifac,
              "fused_chol_solve": _guaranteed_fcs}


# Pivots at the edge of the breakdown test. LAPACK's potrf (the plain
# versions' factor on the CPU, and the JAX package's) stops at a pivot <= 0
# or NaN and factors on at an infinite one: an infinite diagonal entry at
# (g, g), zeros below it, row g left of it as for any finite pivot (those
# entries never read a_gg), and everything else the factor of the matrix
# with row and column g deleted, operation for operation (the terms that
# pass through column g are exact zeros). So the kernels are held to the
# plain version run on the CPU: the same set of non-finite entries, the
# deleted matrix's entries within the forward-error gate above (applied to
# the deleted matrix), row g and every block or lane away from the special
# ones bit-equal to the kernel's own output on the input without them. A
# negative pivot still gives an all-NaN block, and in tridiag_factor every
# later block of its lane too.
# The cases: chol and fused_chol_solve on 8 blocks of n = 17, block 2 with
# an infinite pivot in row PIVOT_ROW and block 5 indefinite; tridiag_factor
# on a (B, N, n) batch, at one node lane 1 with an infinite pivot in row
# PIVOT_ROW and lane 2 indefinite.
PIVOT_ROW = 5
TRIFAC_PIVOTS = (4, 6, 13, 3)   # tridiag_factor batch (B, N, n), node


def _sparse_spd(g, N: int, n: int):
    """N SPD n x n blocks, float64 on the CPU, from the generator g: a
    quarter of the lower triangle exact zeros (mirrored), the diagonal
    shifted so the smallest eigenvalue is 1."""
    import torch

    f64 = torch.float64
    R = torch.randn(N, n, n, generator=g, dtype=f64)
    zero = torch.tril(torch.rand(N, n, n, generator=g, dtype=f64) < 0.25, -1)
    R = torch.tril(R, -1).masked_fill(zero, 0.0)
    A = R + _T(R)
    return A + (1.0 - torch.linalg.eigvalsh(A)[:, :1, None]) * torch.eye(n, dtype=f64)


def _drop(X, g, axes):
    """X without index g along each of ``axes``."""
    import torch

    for ax in axes:
        keep = torch.tensor([i for i in range(X.shape[ax]) if i != g],
                            device=X.device)
        X = X.index_select(ax, keep)
    return X


def _same(a, b):
    """Bit-equal up to NaN payloads (and the sign of zero)."""
    import torch

    a, b = a.cpu(), b.cpu()
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _finite_as(x, ref) -> bool:
    """x is finite exactly where ref is."""
    import torch

    return torch.equal(torch.isfinite(x.cpu()), torch.isfinite(ref))


def check_pivots(cuda_kkt):
    """chol and fused_chol_solve (N=8 blocks of n=17, the stage Hessian's
    width; 13 right-hand sides) and tridiag_factor (TRIFAC_PIVOTS) at an
    infinite and at a negative pivot, in float32 and float64, against the
    plain versions on the CPU, in float64 as phase 3's reference is; see
    the note above. Returns {check: readings} and ok. A reading, not a
    gate: whether the plain version run on the card in the kernel's dtype
    is non-finite where the reference is (not every build of torch's
    Cholesky factors on at an infinite pivot: the float32 one on the CPU of
    an MKL build stops there at n = 6 and 13, not at 17)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(3)
    f64 = torch.float64
    n, j = 17, PIVOT_ROW
    i_inf, i_neg = 2, 5
    R = torch.randn(8, n, n, generator=g, dtype=f64)
    A0 = R @ _T(R) + n * torch.eye(n, dtype=f64)
    Bm = torch.randn(8, n, 13, generator=g, dtype=f64)
    A = A0.clone()
    A[i_inf, j, j] = float("inf")
    A[i_neg] -= (torch.linalg.eigvalsh(A0[i_neg])[0] + 1.0) * torch.eye(n, dtype=f64)
    B, N, nt, node = TRIFAC_PIVOTS
    R = torch.randn(B * N, nt, nt, generator=g, dtype=f64)
    D0 = (R @ _T(R) + 5 * torch.eye(nt, dtype=f64)).reshape(B, N, nt, nt) \
        + 4.0 * nt * torch.eye(nt, dtype=f64)
    O = 0.5 * torch.randn(B, N - 1, nt, nt, generator=g, dtype=f64)
    D = D0.clone()
    D[1, node, j, j] = float("inf")
    D[2, node] -= (torch.linalg.eigvalsh(D0[2, node])[0] + 50.0) * torch.eye(nt, dtype=f64)
    out, ok = {}, True
    others = [i for i in range(8) if i not in (i_inf, i_neg)]
    for dt in (torch.float32, f64):
        tag = str(dt).split(".")[1]
        a, a0, bm = A.to(dt), A0.to(dt), Bm.to(dt)
        # chol
        k = cuda_kkt.chol(a.cuda()).cpu()
        k0 = cuda_kkt.chol(a0.cuda()).cpu()
        p = cuda_kkt.chol_plain(a.double())
        Ad, Kd, Pd = (_drop(X[i_inf].double(), j, (0, 1)) for X in (a, k, p))
        fwd = float(_forward_chol((Ad[None],), (Pd[None],), (Kd[None],), dt).max())
        good = (torch.equal(torch.isfinite(k), torch.isfinite(p))
                and bool(torch.isnan(k[i_neg]).all())
                and _same(k[others], k0[others])
                and _same(k[i_inf, j, :j], k0[i_inf, j, :j])
                and bool((k[i_inf, j + 1:, j] == 0).all())
                and bool(torch.isinf(k[i_inf, j, j])) and fwd <= 1.0)
        out[f"chol {tag}"] = {"fwd_kernel": fwd, "ok": good,
                              "card_plain_as_cpu": _finite_as(
                                  cuda_kkt.chol_plain(a.cuda()), p)}
        ok &= good
        # fused_chol_solve
        x = cuda_kkt.fused_chol_solve(a.cuda(), bm.cuda()).cpu()
        x0 = cuda_kkt.fused_chol_solve(a0.cuda(), bm.cuda()).cpu()
        xp = cuda_kkt.fused_chol_solve_plain(a.double(), bm.double())
        Ad = _drop(a.double()[i_inf], j, (0, 1))
        Bd, Xd, Xpd = (_drop(X[i_inf].double(), j, (0,)) for X in (bm, x, xp))
        fwd = float(_forward_fcs((Ad[None], Bd[None]), (Xpd[None],),
                                 (Xd[None],), dt).max())
        good = (torch.equal(torch.isfinite(x), torch.isfinite(xp))
                and bool(torch.isnan(x[i_neg]).all())
                and _same(x[others], x0[others])
                and bool((x[i_inf, j] == 0).all()) and fwd <= 1.0)
        out[f"fused_chol_solve {tag}"] = {
            "fwd_kernel": fwd, "ok": good, "card_plain_as_cpu": _finite_as(
                cuda_kkt.fused_chol_solve_plain(a.cuda(), bm.cuda()), xp)}
        ok &= good
        # tridiag_factor: lane 1 the infinite pivot, lane 2 the negative one
        d, d0, o = D.to(dt), D0.to(dt), O.to(dt)
        L, C = (t.cpu() for t in cuda_kkt.tridiag_factor(d.cuda(), o.cuda()))
        L0, C0 = (t.cpu() for t in cuda_kkt.tridiag_factor(d0.cuda(), o.cuda()))
        Lp, Cp = cuda_kkt.tridiag_factor_plain(d.double(), o.double())
        gg = node * nt + j   # the infinite pivot's row in the dense factor
        args64 = (d[1:2].double(), o[1:2].double())
        den_d, den_o = _trifac_den(args64, Lp[1:2], Cp[1:2])
        den = _drop(_dense(den_d, _T(den_o), sym=True), gg, (1, 2))
        Lr = _drop(_dense(Lp[1:2], _T(Cp[1:2, 1:]), sym=False), gg, (1, 2))
        Lk = _drop(_dense(L[1:2].double(), _T(C[1:2, 1:].double()), sym=False),
                   gg, (1, 2))
        tol = _chol_forward(Lr, _both(2 * nt + 2, dt) * den)
        fwd = float(_omega(torch.tril(Lk - Lr), torch.tril(tol)).max())
        good = (torch.equal(torch.isfinite(L), torch.isfinite(Lp))
                and torch.equal(torch.isfinite(C), torch.isfinite(Cp))
                and bool(torch.isnan(L[2, node:]).all())
                and bool(torch.isnan(C[2, node + 1:]).all())
                and _same(L[2, :node], L0[2, :node])
                and _same(C[2, :node + 1], C0[2, :node + 1])
                and _same(L[[0, 3]], L0[[0, 3]]) and _same(C[[0, 3]], C0[[0, 3]])
                and _same(L[1, :node], L0[1, :node])
                and _same(C[1, :node + 1], C0[1, :node + 1])
                and _same(L[1, node, j, :j], L0[1, node, j, :j])
                and bool((L[1, node, j + 1:, j] == 0).all())
                and bool((C[1, node + 1, j] == 0).all())
                and bool(torch.isinf(L[1, node, j, j])) and fwd <= 1.0)
        out[f"tridiag_factor {tag}"] = {
            "fwd_kernel": fwd, "ok": good, "card_plain_as_cpu": _finite_as(
                cuda_kkt.tridiag_factor_plain(d.cuda(), o.cuda())[0], Lp)}
        ok &= good
    torch.cuda.synchronize()
    return out, bool(ok)


def check_call(name, args, kernel, plain):
    """Hold one captured call of a kernel against its plain version.

    Runs the plain version in float64 (the reference) and float32 and the
    kernel in both dtypes on the same inputs. Fails (returns ok=False) if
    a kernel is non-finite in a lane where success in its dtype is
    guaranteed; if, in such a lane, its error against the reference exceeds
    the forward bound or a residual exceeds its backward bound. The plain
    float32 version losing a guaranteed lane fails it too: the guarantee
    would then be wrong. Readings are fractions of the bounds (<= 1)."""
    import torch

    def cast(dt):
        return [a.to(dt) if a.is_floating_point() else a for a in args]

    a32, a64 = cast(torch.float32), cast(torch.float64)
    ref, p32 = _tuple(plain(*a64)), _tuple(plain(*a32))
    k32, k64 = _tuple(kernel(*a32)), _tuple(kernel(*a64))
    fr, fp = _lane_finite(ref), _lane_finite(p32)
    fk32, fk64 = _lane_finite(k32), _lane_finite(k64)
    sure32 = GUARANTEED[name](a64, ref, torch.float32) & fr
    sure64 = GUARANTEED[name](a64, ref, torch.float64) & fr
    out = {"lanes": int(fr.numel()), "ref_finite": int(fr.sum()),
           "f32_guaranteed": int(sure32.sum()),
           "f64_guaranteed": int(sure64.sum()),
           "plain32_finite": int(fp.sum()), "kernel32_finite": int(fk32.sum()),
           "kernel64_finite": int(fk64.sum()),
           "kernel32_lost": int((sure32 & ~fk32).sum()),
           "plain32_lost": int((sure32 & ~fp).sum()),
           "kernel64_lost": int((sure64 & ~fk64).sum()),
           "max_abs_err": float((torch.cat([_lanes(k) for k in k32], 1)
                                 - torch.cat([_lanes(p) for p in p32], 1))
                                .abs().nan_to_num(0.0).max())}
    ok = (out["kernel32_lost"] == 0 and out["plain32_lost"] == 0
          and out["kernel64_lost"] == 0)
    for tag, ins, k, sure, plain_outs, dt in (
            ("f32", a32, k32, sure32 & fk32 & fp, p32, torch.float32),
            ("f64", a64, k64, sure64 & fk64, ref, torch.float64)):
        readings = {"fwd_kernel": FORWARD[name](a64, ref, k, dt)}
        if tag == "f32":
            readings["fwd_plain"] = FORWARD[name](a64, ref, plain_outs, dt)
        for who, outs in (("kernel", k), ("plain", plain_outs)):
            for part, (om, n_terms) in BACKWARD[name](ins, outs).items():
                readings[f"bwd_{part}_{who}"] = om / (2 * _gamma(n_terms, dt))
        for key, r in readings.items():
            val = float(r[sure].max()) if bool(sure.any()) else 0.0
            out[f"{key}_{tag}"] = val
            if "kernel" in key:
                ok &= val <= 1.0
    torch.cuda.synchronize()
    out["ok"] = bool(ok)
    return out


# discretize_lanes gates, per lane and per output (A, Bm, Bp, S, z, x_end),
# normwise against the float64 plain version (the reference), chosen before
# any reading of the kernel on the card. Two correct implementations of this
# function differ by rounding order only: on the CPU the JAX package's f64
# integrator and the port's plain version differ by at most 3.1 f64 ulps
# normwise (B=16 dispersed scenarios with drag, K=50, 8 substeps), and the
# f32 plain version lies within 8.4 f32 ulps of the f64 one. So:
#   f64 kernel: ||k64 - ref|| <= DISC_F64_ULPS u64 ||ref||;
#   f32 kernel: ||k32 - ref|| <= DISC_F32_FACTOR max(||p32 - ref||,
#               DISC_F32_FLOOR_ULPS u32 ||ref||), p32 the f32 plain version;
# and both kernels finite in exactly the lanes where the reference is.
DISC_F64_ULPS = 256
DISC_F32_FACTOR = 8
DISC_F32_FLOOR_ULPS = 32
DISC_OUT = ("A", "Bm", "Bp", "S", "z", "x_end")


def _disc_cast(args, dt):
    model, params, X, U, sigma, substeps, foh = args
    return (model, params.map(lambda v, tail: v.to(dt)), X.to(dt), U.to(dt),
            sigma.to(dt), substeps, foh)


def check_disc(args, kernel, plain):
    """Hold one discretize_lanes call against its plain version: the plain
    version in float64 (the reference) and float32, the kernel in both, on
    the same inputs. Readings are fractions of the gates above (<= 1)."""
    import torch

    a32, a64 = _disc_cast(args, torch.float32), _disc_cast(args, torch.float64)
    ref, p32 = plain(*a64), plain(*a32)
    k32, k64 = kernel(*a32), kernel(*a64)
    torch.cuda.synchronize()
    n_lanes = ref[-1].numel() // ref[-1].shape[-1]

    def lanes(o):
        return o.double().reshape(n_lanes, -1)

    def finite(outs):
        return torch.stack([torch.isfinite(lanes(o)).all(1) for o in outs]).all(0)

    def top(x, mask):
        return float(x[mask].max()) if bool(mask.any()) else 0.0

    fr, fp, fk32, fk64 = finite(ref), finite(p32), finite(k32), finite(k64)
    both = fr & fp
    u32, u64 = 2.0 ** -24, 2.0 ** -53
    out = {"lanes": n_lanes, "ref_finite": int(fr.sum()),
           "plain32_finite": int(fp.sum()), "kernel32_finite": int(fk32.sum()),
           "kernel64_finite": int(fk64.sum()),
           "kernel_finite_mismatch": int((fk32 != fr).sum() + (fk64 != fr).sum()),
           "max_abs_err": max(top((lanes(k) - lanes(p)).abs().amax(1), both)
                              for k, p in zip(k32, p32))}
    ok = out["kernel_finite_mismatch"] == 0
    for name, r, o64, o32, op in zip(DISC_OUT, ref, k64, k32, p32):
        r = lanes(r)
        n = r.norm(dim=1)
        e64, e32, ep = ((lanes(o) - r).norm(dim=1) for o in (o64, o32, op))
        read64 = e64 / (DISC_F64_ULPS * u64 * n).clamp(min=1e-300)
        read32 = e32 / (DISC_F32_FACTOR * torch.maximum(
            ep, DISC_F32_FLOOR_ULPS * u32 * n)).clamp(min=1e-300)
        out[f"{name}_f64"] = top(read64, fr)
        out[f"{name}_f32"] = top(read32, both)
        out[f"{name}_ulps64"] = top(e64 / (u64 * n).clamp(min=1e-300), fr)
        out[f"{name}_ulps32_kernel"] = top(e32 / (u32 * n).clamp(min=1e-300), both)
        out[f"{name}_ulps32_plain"] = top(ep / (u32 * n).clamp(min=1e-300), both)
        ok &= out[f"{name}_f64"] <= 1.0 and out[f"{name}_f32"] <= 1.0
    out["ok"] = bool(ok)
    return out


def _time_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around ``reps`` calls, after a
    warm-up. A spin kernel holds the stream while the host enqueues the
    calls, so the events time the device's work back to back and not the
    host's launch overhead (a ctypes launch costs tens of microseconds of
    host time, more than the smallest kernel here runs). If enqueueing
    took longer than the spin (a busy host: phase 4's CPU runs share it),
    the device idled between calls, and the reading is taken again with a
    spin twice that long."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    fn()
    t_host = time.perf_counter() - t_host
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    spin = min(2.0 * reps * t_host, 2.0)  # seconds: twice the enqueue time
    for _ in range(4):
        torch.cuda._sleep(int(spin * 2e9))   # ~2e9 cycles a second
        t0.record()
        t_enqueue = time.perf_counter()
        for _ in range(reps):
            fn()
        t1.record()
        t_enqueue = time.perf_counter() - t_enqueue
        torch.cuda.synchronize()
        if t_enqueue < spin or spin >= 2.0:
            break
        spin = min(2.0 * t_enqueue, 2.0)
    return t0.elapsed_time(t1) / reps


def _work(name: str, args, esize: int):
    """(bytes, flops) the function must move and compute on these inputs:
    every input read once, every output written once. ``chol`` reads only
    the lower triangle of each A block and the solves only that of each L
    block, so only it counts."""
    if name in ("discretize_lanes", PM_DISC):
        from successiveconvexification_tpu_torch.ops import cuda_disc

        model, params, X, U, sigma, substeps, foh = args
        f_val, f_tan = DYNAMICS_FLOPS[cuda_disc.kernel_dynamics(model)]
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


# flops of one evaluation of each model's dynamics in csrc/disc.cu, counted
# from the source on dual numbers (sign flips free): the value once, and
# each tangent direction's derivative part
DYNAMICS_FLOPS = {"rocket6dof": (133, 241), "pointmass3dof": (14, 23)}


def _time_kernel(name, args, kernel, plain, library):
    """Device ms of the kernel, its plain version and the library call (or
    None), and the bound for this call's work."""
    import torch

    ms = _time_ms(lambda: kernel(*args))
    # few reps: the plain versions launch hundreds of small kernels a call,
    # and the stream's queue must hold them all while held
    plain_ms = _time_ms(lambda: plain(*args), reps=2)
    lib_ms = None if library is None else _time_ms(lambda: library(*args))
    esize = next(a for a in args if torch.is_tensor(a)).element_size()
    nbytes, flops = _work(name, args, esize)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float64" if esize == 8 else "float32"] * 1e3
    return ms, plain_ms, lib_ms, {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, "mbytes": nbytes / 1e6, "gflop": flops / 1e9}


def _blockwise(args):
    """A call's tensors with every leading axis folded into one block axis,
    so the checks see each block as a lane."""
    return tuple(a.reshape(-1, *a.shape[-2:]) for a in args)


def profile_iteration(P, model, cfg, r) -> dict:
    """One warm replan iteration (from the warm-started state) under
    torch.profiler: the device operations (kernels, copies, sets), the
    union of their intervals, and the aten operator calls (nested
    included), counted as scripts/profile_torch_iteration.py counts."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from profile_torch_iteration import device_busy_ms

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        P.scvx_iteration(model, r["params"], cfg, r["warm0"])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise PhaseError("profile: the trace holds no device events")
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    return {"wall_ms": wall, "device_ops": len(dev),
            "busy_ms": device_busy_ms(dev)[0],
            "aten_calls": sum(e.count for e in ops)}


def device_kernels(fn) -> list[str]:
    """The names of the device operations (kernels, copies) one call of
    ``fn`` runs, from torch.profiler."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def counted(batch_mod, wrappers, caps, fn):
    """Run ``fn()`` on the card with every launch counter set to 0 just
    before and read just after, counting the lockstep SCvx iterations and
    those that paid a cold init. ``caps`` keep each kernel's chosen first
    call and every call of lockstep iteration LATE_LOCKSTEP (or of the last
    one, if the run ends before it). Returns (result, launches, counts with
    the synchronized wall)."""
    import torch

    counts = {"lockstep": 0, "cold": 0}
    orig_iter = batch_mod.scvx_iteration

    def counting_iteration(model_, params_, cfg_, st_, assume_warm_valid=False):
        counts["lockstep"] += 1
        counts["cold"] += 0 if assume_warm_valid else 1
        if counts["lockstep"] == LATE_LOCKSTEP:
            for c in caps.values():
                c.recent.clear()
        out_ = orig_iter(model_, params_, cfg_, st_,
                         assume_warm_valid=assume_warm_valid)
        if counts["lockstep"] == LATE_LOCKSTEP:
            for c in caps.values():
                c.late = list(c.recent)
        return out_

    batch_mod.scvx_iteration = counting_iteration
    try:
        with contextlib.ExitStack() as stack:
            for c in caps.values():
                stack.enter_context(c)
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            counts["wall"] = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
    finally:
        batch_mod.scvx_iteration = orig_iter
    for c in caps.values():
        c.late = list(c.recent) if c.late is None else c.late
    return out, launches, counts


def check_launches(label, launches, counts, per_iter, per_cold,
                   warm_starts: int = 0):
    """Print a run's launches beside the IPM's structure (``per_iter`` and
    ``per_cold`` a factorization, one discretize a lockstep SCvx iteration
    and one a warm start) and fail unless the path's kernels launched and
    every count matches."""
    # the kernel that launches once per factorization counts IPM iterations
    anchor = next(k for k in WRAPPED if per_iter[k] == 1 and per_cold[k] == 1)
    n_body = launches[anchor] - counts["cold"]
    n_disc = counts["lockstep"] + warm_starts
    expect = {k: per_iter[k] * n_body + per_cold[k] * counts["cold"]
              + PER_SCVX[k] * n_disc for k in launches}
    print(f"{label} launches: {json.dumps(launches)}")
    print(f"  expected from {n_body} IPM iterations + {counts['cold']} cold "
          f"inits + {counts['lockstep']} SCvx iterations"
          f"{f' + {warm_starts} warm start' if warm_starts else ''}: "
          f"{json.dumps(expect)}")
    path_kernels = [k for k in launches
                    if per_iter[k] or (PER_SCVX[k] and n_disc)]
    if any(launches[k] == 0 for k in path_kernels):
        raise PhaseError(f"{label}: a kernel never launched: {launches}")
    if launches != expect:
        raise PhaseError(f"{label}: launch counts do not match the IPM")


def _launch_error(label, launches, counts, per_iter_, per_cold):
    """``check_launches``'s verdict as a message (None when it holds), for
    a child that reports to the parent."""
    try:
        check_launches(label, launches, counts, per_iter_, per_cold)
    except PhaseError as e:
        return str(e)
    return None


def _pct(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(math.ceil(q * len(v))) - 1)]


def run_sweep(P, batch_mod, label, model, cfg, pb, wrappers, caps, per_iter,
              per_cold, card, solve=None, warm_starts: int = 0):
    """Drive a sweep the way the main path runs (``solve_batch_compact_device``
    with chunk 10 and min bucket 32, or ``solve()``) on the card through
    ``counted``; print its line and launches, and fail unless the
    trajectories are finite and well shaped, at least half the lanes
    converge, the path's kernels launched, and every count matches the
    IPM's structure (``check_launches``)."""
    import torch

    if solve is None:
        def solve():
            return P.solve_batch_compact_device(model, pb, cfg, chunk=10,
                                                min_bucket=32, device="cuda")
    out, launches, counts = counted(batch_mod, wrappers, caps, solve)
    wall = counts["wall"]
    B, K = pb.batch_shape[0], cfg.disc.K
    finite = all(bool(torch.isfinite(t).all()) for t in (out.X, out.U, out.sigma))
    shapes = (tuple(out.X.shape) == (B, K, model.nx)
              and tuple(out.U.shape) == (B, K, model.nu))
    n_conv = int(out.converged.sum())
    its = out.iterations.tolist()
    feas = (out.defect_nl + out.viol_nl)[out.converged]
    ms_iter = 1e3 * wall / max(counts["lockstep"], 1)
    print(f"{label}: B={B} K={K} substeps={cfg.disc.substeps} {cfg.dtype}: "
          f"{n_conv}/{B} converged, iterations p50 {_pct(its, 0.5)} p90 "
          f"{_pct(its, 0.9)} max {max(its)}, wall {wall:.3f} s, "
          f"{counts['lockstep']} lockstep SCvx iterations "
          f"({counts['cold']} with a cold init), {ms_iter:.2f} ms per "
          f"SCvx iteration, sigma mean {float(out.sigma.mean()):.4f}, "
          f"max converged defect+violation {float(feas.max()) if n_conv else float('nan'):.3e}")
    if not (finite and shapes):
        raise PhaseError(f"{label}: non-finite or misshapen trajectories")
    if n_conv < B // 2:
        raise PhaseError(f"{label}: only {n_conv}/{B} lanes converged")
    check_launches(label, launches, counts, per_iter, per_cold, warm_starts)
    return out, launches, dict(counts, ms_iter=ms_iter, p50=_pct(its, 0.5),
                               p90=_pct(its, 0.9), max=max(its))


def check_sharded(a: dict, bc: dict, card: str) -> None:
    """Print phase 2h's readings (its children's) and fail unless (a)
    run_batch gave solve_batch's final state bit for bit with launches
    that match the IPM's structure, (b) the crashed run's checkpoint held
    the step of the crash and its resume gave the uninterrupted run's
    final state bit for bit, and (c) the CLI's second run resumed the
    finished sweep with the first run's record."""
    ms = a["commit_ms"]
    print(f"2h (a) sharded sweep: run_batch on an NCCL group of 1 rank, a "
          f"commit every {SHARD_CKPT_EVERY}, against solve_batch: B={a['B']} "
          f"K={MAIN_K} float32: {a['converged']}/{a['B']} converged, "
          f"iterations max {a['max_iterations']}; wall solve_batch "
          f"{a['solve_batch']['wall']:.3f} s, run_batch "
          f"{a['run_batch']['wall']:.3f} s ({a['run_batch']['lockstep']} "
          f"lockstep SCvx iterations, {a['run_batch']['cold']} with a cold "
          f"init; solve_batch {a['solve_batch']['lockstep']}, "
          f"{a['solve_batch']['cold']}); {a['commits']} commits, host time a "
          f"commit mean {sum(ms) / max(len(ms), 1):.3f} ms (min "
          f"{min(ms, default=float('nan')):.3f}, max "
          f"{max(ms, default=float('nan')):.3f}); checkpoint step "
          f"{a['step']}; {a['same']}/{a['leaves']} leaves equal bit for bit; "
          f"run_batch launches {json.dumps(a['run_batch']['launches'])}; "
          f"{card}")
    errors = [a[k]["launch_error"] for k in ("solve_batch", "run_batch")
              if a[k]["launch_error"]]
    if errors or not (a["same"] == a["leaves"] and a["finite"]
                      and a["converged"] >= a["B"] // 2 and a["commits"] >= 1
                      and a["step"] == a["commits"] * SHARD_CKPT_EVERY):
        raise PhaseError(f"2h (a): run_batch is not solve_batch bit for bit, "
                         f"or its launches or commits are wrong {errors}")
    print(f"2h (b) crash and resume, point-mass path B={MAIN_B} K={PM_K} "
          f"float32 under run_batch, a commit every {PM_CKPT_EVERY}: exit "
          f"codes {json.dumps(bc['rc'])} (crash 9 expected); the crashed "
          f"run's checkpoint at step {bc['crash_step']}, resumed from step "
          f"{bc.get('resume_start')}; walls {json.dumps(bc.get('walls'))} s; "
          f"{bc.get('converged')}/{MAIN_B} converged; "
          f"{bc.get('same')}/{bc.get('leaves')} leaves of the resumed run "
          f"equal the uninterrupted run's bit for bit")
    if not (bc["rc"] == {"full": 0, "crash": 9, "resume": 0}
            and bc["crash_step"] == PM_CRASH_STEP
            and bc.get("resume_start") == PM_CRASH_STEP
            and bc.get("same") == bc.get("leaves") is not None):
        raise PhaseError("2h (b): the crash and resume is not bit for bit")
    recs = bc["cli"]
    print(f"2h (c) cli sweep --distributed --num-processes 1 --ckpt-every "
          f"{CLI_CKPT_EVERY} --batch 8 --disc.K={ATMO_K}, twice: exit codes "
          f"{bc['cli_rc']}; records {json.dumps(recs)}; checkpoint step "
          f"{bc['cli_step']}")
    if not (bc["cli_rc"] == [0, 0] and len(recs) == 2
            and recs[0]["n_total"] == recs[1]["n_total"] == 8
            and recs[0]["mean_iterations"] == recs[1]["mean_iterations"]
            and bc["cli_step"] >= CLI_CKPT_EVERY):
        raise PhaseError("2h (c): the CLI's resume gave another record")


def check_ksharded(k: dict, r: dict, nom: dict, nom64: float,
                   card: str) -> None:
    """Print phase 2i's readings (its child's) and fail unless (a) the
    reference subproblem converged on the card with ksharded and with scan,
    w within atol 1e-6 and sig within 1e-8 of each other (the JAX test's
    gate), and the CPU's ksharded solve within the same gate of the card's
    with as many IPM iterations; (b) the ksharded scvx_solve converged
    with a sigma within 1e-2 of the f64 nominal's on the card (``nom64``,
    phase 4; the JAX package's f32-against-f64 gate at this horizon,
    ``tests/test_scvx.py::test_f32_matches_f64_at_flagship_horizon``) and
    no more than 1e-3 relative above the lower of the f32 cold solves of
    the same nominal on the other routes: phase 2b's (PCR, ``r``) and phase
    2f's (fused scan, ``nom``). One-sided, because in float32 those cold
    solves stop above the optimum on the H100 (by 1.9e-2 and 7.5e-3
    relative; ROADMAP Queue 3), so a two-sided 1e-3 gate against either
    holds the route to where the other stopped, not to the optimum;
    (c) its launches matched the IPM's structure; (d) every check of
    tridiag_factor and tridiag_solve passed, the interior chain, the folded
    columns and the reduced system (N = 1) among them."""
    a = {key[2:]: v for key, v in k.items() if key.startswith("a_")}
    print("2i (a) ksharded on an NCCL group of 1 rank, the JAX test's "
          f"subproblem (K={MAIN_K}, 3 substeps, float64, IPM cap 45): "
          + "; ".join(f"{key}: converged {v['converged']} in {v['iters']} "
                      f"IPM iterations, sig {v['sig']:.12f}, "
                      f"{v['seconds']:.2f} s"
                      + (f", |w - card ksharded| {v['w_diff']:.3e} (gate "
                         f"1e-6), |sig - card ksharded| {v['sig_diff']:.3e} "
                         "(gate 1e-8)" if "w_diff" in v else "")
                      for key, v in a.items()))
    ks_card, scan, cpu = a["card_ksharded"], a["card_scan"], a["cpu_ksharded"]
    if not (ks_card["converged"] and scan["converged"] and cpu["converged"]
            and all(v["w_diff"] <= 1e-6 and v["sig_diff"] <= 1e-8
                    for v in (scan, cpu))
            and cpu["iters"] == ks_card["iters"]):
        raise PhaseError("2i (a): ksharded disagrees with scan or with the CPU")
    b, sm = k["b"], r["summary"]
    over = b["sigma"] / min(sm["cold_sigma"], nom["sigma"]) - 1.0
    d64 = abs(b["sigma"] - nom64)
    print(f"2i (b) ksharded scvx_solve of the nominal rocket, K={MAIN_K}, "
          f"{MAIN_SUBSTEPS} substeps, float32, bench.py's settings: converged "
          f"{b['converged']} in {b['iterations']} SCvx iterations, wall "
          f"{b['wall']:.3f} s, {1e3 * b['wall'] / max(b['lockstep'], 1):.2f} "
          f"ms per SCvx iteration, sigma {b['sigma']:.6f}; |sigma - the f64 "
          f"nominal's {nom64:.6f}| {d64:.3e} (gate 1e-2); phase 2b's cold "
          f"PCR solve: {sm['cold_iterations']} iterations, "
          f"{r['cold_s']:.3f} s, "
          f"{1e3 * r['cold_s'] / max(sm['cold_iterations'], 1):.2f} ms per "
          f"SCvx iteration, sigma {sm['cold_sigma']:.6f}; phase 2f's cold "
          f"nominal (fused scan): {nom['iterations']} iterations, "
          f"{nom['wall']:.3f} s, sigma {nom['sigma']:.6f}; ksharded over the "
          f"lower of the two, relative {over:.3e} (gate <= 1e-3); {card}")
    print(f"2i (c) launches {json.dumps(b['launches'])}"
          + (f": {b['launch_error']}" if b["launch_error"] else
             " as the IPM's structure says"))
    if not (b["converged"] and b["finite"] and d64 <= 1e-2
            and over <= 1e-3):
        raise PhaseError("2i (b): the ksharded solve did not converge to "
                         "the nominal's sigma")
    if b["launch_error"]:
        raise PhaseError(f"2i (c): {b['launch_error']}")
    e = k["e"]
    ks_g, scan_g = e["ksharded"], e["scan"]
    print(f"2i (e) the (a) subproblem with {GONDZIO} correctors an IPM "
          f"iteration on the card: ksharded converged {ks_g['converged']} in "
          f"{ks_g['iters']} IPM iterations ({ks_g['seconds']:.2f} s; without "
          f"them {ks_card['iters']}), scan converged {scan_g['converged']} "
          f"in {scan_g['iters']} ({scan_g['seconds']:.2f} s); |w - scan| "
          f"{e['w_diff']:.3e} (gate 1e-6), |sig - scan| {e['sig_diff']:.3e} "
          f"(gate 1e-8), |w - ksharded without them| {e['w_diff_g0']:.3e} "
          f"(gate 5e-6); ksharded launches {json.dumps(ks_g['launches'])}")
    errors = [x["launch_error"] for x in (ks_g, scan_g) if x["launch_error"]]
    if errors or not (ks_g["converged"] and scan_g["converged"]
                      and e["w_diff"] <= 1e-6 and e["sig_diff"] <= 1e-8
                      and ks_g["iters"] <= ks_card["iters"] + 2
                      and e["w_diff_g0"] <= 5e-6):
        raise PhaseError(f"2i (e): ksharded with correctors disagrees with "
                         f"scan or with g=0, or launched wrong {errors}")
    kinds = collections.defaultdict(list)
    for c in k["d"]:
        kinds[c["name"], tuple(map(tuple, c["shapes"]))].append(c)
    for (name, shapes), res in kinds.items():
        reads = "; ".join(f"{key} {max(x[key] for x in res):.3f}"
                          for key in res[0] if key.startswith(("fwd_", "bwd_")))
        n_bad = sum(not x["ok"] for x in res)
        print(f"2i (d) check {name} at {list(shapes)} ({len(res)} call(s) "
              f"of (b)): guaranteed lanes lost by the kernel f32 "
              f"{sum(x['kernel32_lost'] for x in res)}, f64 "
              f"{sum(x['kernel64_lost'] for x in res)}; {reads} -> "
              f"{'ok' if n_bad == 0 else f'FAIL in {n_bad}'}")
    # (name, lanes, blocks): the interior chain, the reduced system and
    # the folded columns of Ya and Zb
    held = {(name, shapes[0][0], shapes[0][1]) for name, shapes in kinds}
    interior = MAIN_K - 2
    must = {("tridiag_factor", 1, interior), ("tridiag_factor", 1, 1),
            ("tridiag_solve", 1, interior), ("tridiag_solve", 1, 1),
            ("tridiag_solve", k["nrx"], interior)}
    if any(not c["ok"] for c in k["d"]) or not must <= held:
        raise PhaseError("2i (d): tridiag_factor or tridiag_solve disagrees "
                         "with its plain version, or a kind of call was not "
                         "held")


def check_gondzio_host(j: dict, r: dict, nom: dict, nom64: float,
                       main_counts: dict, card: str) -> None:
    """Print phase 2j's readings (its child's) and fail unless (a) on each
    route (fused scan, PCR, the penalized model's unfused scan) the
    reference subproblem converged on the card at 0 and at GONDZIO
    correctors with at most two more IPM iterations and w within atol 5e-6
    (the JAX package's gate, ``tests/test_ipm_structured.py:185-196``), the
    CPU's solve at GONDZIO (plain versions) converged in as many IPM
    iterations with w within atol 1e-6 and sig within 1e-8 of the card's,
    and every card solve launched as the route's structure says with the
    corrector terms; (b) the f32 nominal with GONDZIO correctors converged
    within 1e-2 of the f64 nominal on the card (``nom64``) and no more than
    1e-3 relative above the lower of phase 2b's and 2f's f32 cold solves
    (``check_ksharded`` says why one-sided), with its launches; (c) the
    host-compacting sweep repacked, launched as the IPM's structure says,
    and gave phase 2's final state bit for bit: the card's kernels and
    plain stages repeat their bits across processes."""
    for route, a in j["a"].items():
        g0, g2, cpu = a["card_g0"], a[f"card_g{GONDZIO}"], a[f"cpu_g{GONDZIO}"]
        print(f"2j (a) {route}, the 2i reference subproblem (K={MAIN_K}, 3 "
              f"substeps, float64, IPM cap 45): card g=0 converged "
              f"{g0['converged']} in {g0['iters']} IPM iterations "
              f"({g0['seconds']:.2f} s); card g={GONDZIO} converged "
              f"{g2['converged']} in {g2['iters']} ({g2['seconds']:.2f} s), "
              f"|w - g=0| {a['w_diff_g0']:.3e} (gate 5e-6); CPU g={GONDZIO} "
              f"converged {cpu['converged']} in {cpu['iters']}, |w - card| "
              f"{a['w_diff_cpu']:.3e} (gate 1e-6), |sig - card| "
              f"{a['sig_diff_cpu']:.3e} (gate 1e-8); card g={GONDZIO} "
              f"launches {json.dumps(g2['launches'])}; {card}")
        errors = [x["launch_error"] for x in (g0, g2) if x["launch_error"]]
        if errors or not (
                g0["converged"] and g2["converged"] and cpu["converged"]
                and g2["iters"] <= g0["iters"] + 2
                and a["w_diff_g0"] <= 5e-6 and a["w_diff_cpu"] <= 1e-6
                and a["sig_diff_cpu"] <= 1e-8
                and cpu["iters"] == g2["iters"]):
            raise PhaseError(f"2j (a) {route}: the correctors disagree with "
                             f"g=0 or with the CPU, or launched wrong "
                             f"{errors}")
    b, sm = j["b"], r["summary"]
    over = b["sigma"] / min(sm["cold_sigma"], nom["sigma"]) - 1.0
    d64 = abs(b["sigma"] - nom64)
    print(f"2j (b) scvx_solve of the nominal rocket with {GONDZIO} correctors "
          f"an IPM iteration, fused scan, K={MAIN_K}, float32, bench.py's "
          f"settings: converged {b['converged']} in {b['iterations']} SCvx "
          f"iterations ({b['ipm_iterations']} IPM iterations, "
          f"{b['cold']} cold inits), wall {b['wall']:.3f} s, "
          f"{1e3 * b['wall'] / max(b['lockstep'], 1):.2f} ms per SCvx "
          f"iteration, sigma {b['sigma']:.6f}; phase 2f's nominal without "
          f"them: {nom['iterations']} SCvx iterations "
          f"({nom['ipm_iterations']} IPM iterations), {nom['wall']:.3f} s, "
          f"{1e3 * nom['wall'] / max(nom['iterations'], 1):.2f} ms per SCvx "
          f"iteration, sigma {nom['sigma']:.6f}; |sigma - the f64 nominal's "
          f"{nom64:.6f}| {d64:.3e} (gate 1e-2); over the lower of 2b's and "
          f"2f's, relative {over:.3e} (gate <= 1e-3); launches "
          f"{json.dumps(b['launches'])}; {card}")
    if b["launch_error"] or not (b["converged"] and b["finite"]
                                 and d64 <= 1e-2 and over <= 1e-3):
        raise PhaseError(f"2j (b): the nominal with correctors did not "
                         f"converge to the nominal's sigma, or launched "
                         f"wrong {b['launch_error'] or ''}")
    c = j["c"]
    trips = c["trip_ms"]
    print(f"2j (c) host-compacting sweep (solve_batch_compact, chunk 10, min "
          f"bucket 32), the main path's B={MAIN_B} lanes: wall "
          f"{c['wall']:.3f} s against phase 2's device compaction "
          f"{main_counts['wall']:.3f} s (in this process, before phase 4's "
          f"children); {c['lockstep']} lockstep SCvx iterations "
          f"({c['cold']} with a cold init; phase 2: "
          f"{main_counts['lockstep']}, {main_counts['cold']}); "
          f"{c['converged']}/{MAIN_B} converged, iterations max "
          f"{c['max_iterations']}; {c['chunks']} chunks, bucket sizes "
          f"{c['sizes']}, {c['repacks']} repacks; host round trip a chunk "
          f"(state down, scatter, alive mask, repack, state up) mean "
          f"{sum(trips) / max(len(trips), 1):.3f} ms (min "
          f"{min(trips, default=float('nan')):.3f}, max "
          f"{max(trips, default=float('nan')):.3f}), the last (down, "
          f"scatter, the result up) {c['last_trip_ms']:.3f} ms; "
          f"{c['same']}/{c['leaves']} leaves equal phase 2's bit for bit; "
          f"{card}")
    if c["launch_error"] or not (c["same"] == c["leaves"] and c["finite"]
                                 and c["repacks"] >= 1
                                 and c["converged"] >= MAIN_B // 2):
        raise PhaseError(f"2j (c): the host sweep is not the device "
                         f"driver's bit for bit, did not repack, or launched "
                         f"wrong {c['launch_error'] or ''}")


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi failed"


# ---------------------------------------------------------------- phases
def main(save_captures: str | None = None) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        P, _build, cuda_fused, cuda_kkt, cuda_disc = _import_port()
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from successiveconvexification_tpu_torch.parallel import batch as batch_mod
    from successiveconvexification_tpu_torch.ops import discretize as disc_mod
    from successiveconvexification_tpu_torch.ops import precision

    precision.full_precision()
    t_start = time.perf_counter()
    children = []
    ref_paths = {case: os.path.join(ROOT, "build",
                                    f"chip_smoke_cpu_reference_{case}.json")
                 for case in ("main", "penalized", "pointmass", "seeded")}
    card_paths = {case: q.replace("_cpu_", "_card_")
                  for case, q in ref_paths.items()}
    replan_path = os.path.join(ROOT, "build", "chip_smoke_cpu_replan.json")
    plain_path = os.path.join(ROOT, "build", "chip_smoke_card_plain_factor.json")
    # phase 2g's CLI children: the STC solve's trajectory, the seeded
    # sweep's metrics and checkpoint
    cli_out = {k: os.path.join(ROOT, "build", f"chip_smoke_cli_{k}")
               for k in ("stc.npz", "sweep.jsonl", "ck")}
    try:
        # ---- 1. card and build ------------------------------------------------
        card = _card_line()
        print(card)
        kind = torch.cuda.get_device_name(0)
        print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build: {time.perf_counter() - t0:.1f} s for "
              f"{', '.join(s + '.cu' for s in _build.SOURCES)} (parallel nvcc)")
        for src in _build.SOURCES:
            log = os.path.join(_build.BUILD, f"{src}.log")
            if os.path.exists(log):
                for line in open(log):
                    if ("registers" in line or "spill" in line
                            or "entry function" in line):
                        print(f"  ptxas {src}: {line.strip()}")

        # ---- 2. the main path ----------------------------------------------
        model = P.rocket6dof_model()
        cfg = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True)
        pb = _dispersed(P, MAIN_B, torch.float32, "cuda")
        wrappers = _wrappers(cuda_fused, cuda_kkt, cuda_disc)
        caps = {
            "fused_factor": Capture(cuda_fused, "fused_factor",
                                    PER_COLD["fused_factor"]),
            "tridiag_solve": Capture(cuda_kkt, "tridiag_solve",
                                     PER_COLD["tridiag_solve"]),
            "cho_solve_vec": Capture(cuda_kkt, "cho_solve_vec",
                                     PER_COLD["cho_solve_vec"]),
            # the first lockstep iteration's call
            "discretize_lanes": Capture(cuda_disc, "discretize_lanes", 0),
        }
        out, launches, main_counts = run_sweep(
            P, batch_mod, "main path", model, cfg, pb, wrappers, caps, PER_ITER,
            PER_COLD, card)
        # its final state, for phase 2j's host-compacting sweep
        from successiveconvexification_tpu_torch.utils import tree as tree_mod

        main_state = os.path.join(ROOT, "build", "chip_smoke_2j_main.pt")
        torch.save([t.detach().cpu() for t in tree_mod.tree_leaves(out)],
                   main_state)

        # ---- 2b. the replan path ---------------------------------------------
        rcaps = {name: Capture(cuda_kkt, name, REPLAN_PER_COLD[name])
                 for name in ("chol", "cho_solve", "cho_solve_vec")}
        rdcap = Capture(cuda_disc, "discretize_lanes", 0)
        # bench.py's settings: the latency readings, the kernels' inputs
        cfg_r = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True,
                         kkt="pcr")
        with rcaps["chol"], rcaps["cho_solve"], rcaps["cho_solve_vec"], rdcap:
            r, rlaunches = run_replan(P, batch_mod, model, cfg_r, wrappers,
                                      {**rcaps, "discretize_lanes": rdcap},
                                      BENCH_REPLAN_ITERS, card)
        if not r["summary"]["cold_converged"]:
            raise PhaseError("replan path: the cold solve did not converge")
        busy = profile_iteration(P, model, cfg_r, r)
        print(f"one warm replan iteration under torch.profiler: wall "
              f"{busy['wall_ms']:.1f} ms, {busy['device_ops']} device "
              f"operations, device busy {busy['busy_ms']:.1f} ms "
              f"({100 * busy['busy_ms'] / busy['wall_ms']:.1f}% of the wall), "
              f"{busy['aten_calls']} aten operator calls (nested included)")
        # the same path at static_reg 1e-6 and bench.py's cap: both solves
        # must converge; its last discretize call is held in phase 3 too
        cfg_r6 = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True,
                          kkt="pcr", static_reg=REPLAN_CHECK_REG)
        rdcap6 = Capture(cuda_disc, "discretize_lanes", 0)
        with rdcap6:
            r6, _ = run_replan(P, batch_mod, model, cfg_r6, wrappers,
                               {"discretize_lanes": rdcap6},
                               BENCH_REPLAN_ITERS, card)
        if not (r6["summary"]["cold_converged"] and r6["summary"]["converged"]):
            raise PhaseError(f"replan path at static_reg {REPLAN_CHECK_REG:g}: "
                             "a solve did not converge")
        if not r["summary"]["converged"]:
            print(f"  the replan at static_reg {cfg_r.ipm.static_reg:g} did "
                  f"not re-converge within bench.py's {BENCH_REPLAN_ITERS} "
                  "iterations (ROADMAP Queue 3: its PCR solves end "
                  "uncertified and the summation order decides the path)")

        # ---- 2c. the penalized path ------------------------------------------
        # the main path's dispersions and settings, the throttle direction
        # penalized: the scan route factors without the fused kernel
        pmodel = penalized_model(P)
        cfg_p = _configs(P, "float32", MAIN_K, MAIN_SUBSTEPS, bench=True,
                         w_dir_penalty=PENALTY_W)
        pcaps = {name: Capture(cuda_kkt, name, PENALIZED_PER_COLD[name])
                 for name in ("chol", "cho_solve", "tridiag_factor",
                              "tridiag_solve", "cho_solve_vec")}
        pdcap = Capture(cuda_disc, "discretize_lanes", 0)
        print(f"penalized path: {pmodel.name}, one penalized direction a node "
              f"(the unit thrust direction), w_dir_penalty {PENALTY_W:g}")
        outp, plaunches, _ = run_sweep(
            P, batch_mod, "penalized path", pmodel, cfg_p, pb, wrappers,
            {**pcaps, "discretize_lanes": pdcap}, PENALIZED_PER_ITER,
            PENALIZED_PER_COLD, card)
        both = outp.converged & out.converged
        gap = ((outp.sigma - out.sigma).abs() / out.sigma.abs())[both]
        gs = sorted(gap.tolist())
        print(f"  penalized vs main path, lanes both converged ({len(gs)}): "
              f"sigma relative gap p50 "
              f"{gs[len(gs) // 2] if gs else float('nan'):.3e} max "
              f"{gs[-1] if gs else float('nan'):.3e} (a reading, not a gate)")

        # ---- 2d. the point-mass path -----------------------------------------
        # BASELINE config 1: K=30, fixed final time, maximum final mass
        pm_model, pb_pm, cfg_pm = _pm_case(P, "cuda")
        # tridiag_solve: the first KKT solve, not the Sherman-Morrison solve
        # before it, whose right-hand side g_sig is 0 at a fixed final time
        mcaps = {
            "fused_factor": Capture(cuda_fused, "fused_factor",
                                    PER_COLD["fused_factor"]),
            "tridiag_solve": Capture(cuda_kkt, "tridiag_solve",
                                     PER_COLD["tridiag_solve"] + 1),
            "cho_solve_vec": Capture(cuda_kkt, "cho_solve_vec",
                                     PER_COLD["cho_solve_vec"]),
            "discretize_lanes": Capture(cuda_disc, "discretize_lanes", 0)}
        outm, mlaunches, _ = run_sweep(
            P, batch_mod, "point-mass path", pm_model, cfg_pm, pb_pm, wrappers,
            mcaps, PER_ITER, PER_COLD, card)
        if not bool((outm.sigma == pb_pm.tf_guess).all()):
            raise PhaseError("point-mass path: the fixed final time moved")

        # ---- 2e. fused_chol_solve on its JAX test vehicle ---------------------
        gen = torch.Generator(device="cpu").manual_seed(1)
        N6, n6, m6 = VEHICLE
        R6 = torch.randn(N6, n6, n6, generator=gen, dtype=torch.float64)
        A6 = (R6 @ _T(R6) + 5 * torch.eye(n6, dtype=torch.float64)).cuda()
        B6 = torch.randn(N6, n6, m6, generator=gen, dtype=torch.float64).cuda()
        for w in wrappers.values():
            w.launches = 0
        X6 = cuda_kkt.fused_chol_solve(A6, B6)
        torch.cuda.synchronize()
        vlaunches = {k: w.launches for k, w in wrappers.items()}
        ref6 = torch.linalg.solve(A6, B6)
        err6 = float((X6 - ref6).abs().max())
        ok6 = bool(torch.allclose(X6, ref6, rtol=1e-8, atol=1e-9))
        print(f"fused_chol_solve vehicle (tests/test_pallas_kkt.py:28): N={N6} "
              f"n={n6} m={m6} float64 against torch.linalg.solve: max abs err "
              f"{err6:.3e} (rtol 1e-8, atol 1e-9) -> {'ok' if ok6 else 'FAIL'}; "
              f"launches {json.dumps(vlaunches)}")
        if not ok6 or vlaunches != _counts(fused_chol_solve=1):
            raise PhaseError("fused_chol_solve vehicle: wrong result or launches")

        # ---- 2f. the seeded path -------------------------------------------
        # bench.py's BENCH_MODE=seeded: the nominal scenario solved once,
        # cold, then every lane of the main path's dispersions warm-started
        # from it (STM-corrected) and swept with the main path's compaction
        from successiveconvexification_tpu_torch.models import rocket6dof as rk

        ncaps = {name: Capture(cuda_fused if name == "fused_factor" else cuda_kkt,
                               name, PER_COLD[name])
                 for name in ("fused_factor", "tridiag_solve", "cho_solve_vec")}
        nominal, nlaunches, ncounts = counted(
            batch_mod, wrappers, ncaps, lambda: P.scvx_solve(
                model, rk.default_params(torch.float32, "cuda"), cfg,
                device="cuda"))
        nominal_s = ncounts["wall"]
        print(f"seeded path, nominal: converged {bool(nominal.converged[0])} in "
              f"{int(nominal.iterations[0])} SCvx iterations, sigma "
              f"{float(nominal.sigma[0]):.5f}, nominal_s {nominal_s:.3f}")
        check_launches("seeded path, nominal", nlaunches, ncounts, PER_ITER,
                       PER_COLD)
        if not bool(nominal.converged[0]):
            raise PhaseError("seeded path: the nominal did not converge")
        nom_sol = (nominal.X[0], nominal.U[0], nominal.sigma[0])
        outs, _, scounts = run_sweep(
            P, batch_mod, "seeded path", model, cfg, pb, wrappers, {}, PER_ITER,
            PER_COLD, card, warm_starts=1, solve=lambda: P.solve_batch_seeded(
                model, pb, cfg, nominal_solution=nom_sol, chunk=10,
                min_bucket=32, device="cuda"))
        n_s, n_m = int(outs.converged.sum()), int(out.converged.sum())
        tol_feas = max(cfg.scvx.conv_tol_feas, cfg.scvx.conv_feas_eps_mult
                       * torch.finfo(torch.float32).eps * MAIN_K * model.nx)
        feas_s = (outs.defect_nl + outs.viol_nl)[outs.converged]
        mean_s = float(outs.iterations.double().mean())
        mean_m = float(out.iterations.double().mean())
        both = outs.converged & out.converged
        dsig = (outs.sigma - out.sigma)[both].double()
        its_s = outs.iterations.tolist()
        print(f"seeded path: {n_s}/{MAIN_B} converged, iterations p50 "
              f"{_pct(its_s, 0.5)} p90 {_pct(its_s, 0.9)} max {max(its_s)}, "
              f"{scounts['lockstep']} lockstep SCvx iterations, wall "
              f"{scounts['wall']:.3f} s, {n_s / scounts['wall']:.3f} converged "
              f"solves per second, nominal_s {nominal_s:.3f} (main path: "
              f"{n_m / main_counts['wall']:.3f} converged solves per second); "
              f"mean iterations a lane {mean_s:.3f} against the cold main "
              f"path's {mean_m:.3f}; converged defect+violation at most "
              f"{float(feas_s.max()) if n_s else float('nan'):.3e} (floor "
              f"{tol_feas:.3e}); {card}")
        qs = [0.0, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0]
        qv = (torch.quantile(dsig, torch.tensor(qs, dtype=torch.float64,
                                                device=dsig.device)).tolist()
              if len(dsig) else [])
        print(f"  sigma seeded - main path over {len(dsig)} lanes converged on "
              f"both: quantiles {dict(zip(qs, [round(v, 6) for v in qv]))}; "
              f"{int((dsig < -5e-2).sum())} lanes lower by more than 5e-2, "
              f"{int((dsig > 5e-2).sum())} higher (gate: none higher); sigma "
              f"mean seeded {float(outs.sigma.mean()):.5f}, main path "
              f"{float(out.sigma.mean()):.5f}")
        if not bool((feas_s < tol_feas).all()):
            raise PhaseError("seeded path: a converged lane misses the "
                             "feasibility floor")
        if not mean_s < mean_m:
            raise PhaseError("seeded path: no fewer iterations a lane than "
                             "the cold main path")
        # one-sided in f32: the cold main path stops at a higher sigma than
        # the f64 optimum in many lanes, no seeded lane does (PERF.md,
        # scripts/seeded_vs_cold.py); the two-sided 5e-2 gate of
        # tests/test_seeded.py holds in f64, phase 4
        if bool((dsig >= 5e-2).any()):
            raise PhaseError("seeded path: a lane's sigma is worse than the "
                             "cold main path's by 5e-2 or more")

        # ---- 2g. the atmospheric variants ------------------------------------
        # (a) the angle-of-attack STC: its third linear row makes the fused
        # factor's R one larger; its first and a late fused_factor call join
        # phase 3
        stc_model = P.rocket6dof_model(aoa_stc=True)
        p64 = rk.default_params(torch.float64, "cuda")
        cfg_stc = atmo_cfg(P, 45)
        stc_cap = Capture(cuda_fused, "fused_factor", PER_COLD["fused_factor"])
        stc, alaunches, acounts = counted(
            batch_mod, wrappers, {"fused_factor": stc_cap},
            lambda: P.scvx_solve(stc_model, p64, cfg_stc, device="cuda"))
        r_stc = stc_cap.first[0].shape[2]
        worst = aoa_excess(stc.X[0], p64)
        print(f"STC solve ({stc_model.name}, K={ATMO_K}, float64, at most 45 "
              f"iterations): converged {bool(stc.converged[0])} in "
              f"{int(stc.iterations[0])}, {acounts['wall']:.3f} s, sigma "
              f"{float(stc.sigma[0]):.6f}, defect {float(stc.defect_nl[0]):.3e} "
              f"(gate 1e-3), violation {float(stc.viol_nl[0]):.3e} (gate 1e-4), "
              f"worst angle of attack above alpha_max {worst:.4f} deg above "
              f"the trigger speed (gate 1); fused_factor R = {r_stc}")
        check_launches("STC solve", alaunches, acounts, PER_ITER_REFINE2,
                       PER_COLD)
        r_vac = (P.rocket6dof_model().n_lin + 1 + sum(stc_model.soc_dims)
                 + 1 + stc_model.nr + stc_model.nu)
        if not (bool(stc.converged[0]) and float(stc.defect_nl[0]) < 1e-3
                and float(stc.viol_nl[0]) < 1e-4 and worst < 1.0
                and r_stc == r_vac + 1):
            raise PhaseError("STC solve: not converged, outside a gate, or R "
                             f"{r_stc} is not the vacuum model's {r_vac} + 1")
        # (b) drag (cd_a 0.05) against the vacuum solve at the same settings:
        # one batched solve, lane 0 in vacuum and lane 1 with drag
        cfg_drag = atmo_cfg(P, 40)
        p_atmo = p64.map(lambda v, tail: v.expand((2,) + v.shape).clone())
        p_atmo = p_atmo.replace(cd_a=torch.tensor([0.0, 0.05],
                                                  dtype=torch.float64,
                                                  device="cuda"))
        ddcap = Capture(cuda_disc, "discretize_lanes", 0)
        atmo, dlaunches, dcounts = counted(
            batch_mod, wrappers, {"discretize_lanes": ddcap},
            lambda: P.solve_batch(model, p_atmo, cfg_drag, device="cuda"))
        (dfc_vac, dfc_drag), (vio_vac, vio_drag) = quality(model, p_atmo,
                                                           cfg_drag, atmo)
        sig_vac, sig_drag = atmo.sigma.tolist()
        conv_vac, conv_drag = atmo.converged.tolist()
        its_vac, its_drag = atmo.iterations.tolist()
        dsig_drag = abs(sig_drag - sig_vac)
        print(f"drag solve (cd_a 0.05, K={ATMO_K}, float64, at most 40 "
              f"iterations, batched with the vacuum scenario, "
              f"{dcounts['wall']:.3f} s): converged {conv_drag} in {its_drag}, "
              f"sigma {sig_drag:.6f}, max defect {dfc_drag:.3e} (gate 1e-3), "
              f"violation {vio_drag:.3e} (gate 1e-4); vacuum: converged "
              f"{conv_vac} in {its_vac}, sigma {sig_vac:.6f}, max defect "
              f"{dfc_vac:.3e}, violation {vio_vac:.3e}, worst angle of attack "
              f"above alpha_max {aoa_excess(atmo.X[0], p64):.4f} deg (a "
              f"reading); |sigma drag - vacuum| {dsig_drag:.3e} (gate > 1e-3)")
        check_launches("drag solve", dlaunches, dcounts, PER_ITER_REFINE2,
                       PER_COLD)
        if not (conv_drag and conv_vac and max(dfc_drag, dfc_vac) < 1e-3
                and max(vio_drag, vio_vac) < 1e-4 and dsig_drag > 1e-3):
            raise PhaseError("drag solve: not converged or outside a gate")

        # the CPU halves of phase 4 run beside phases 3 and 5 (not beside the
        # host-bound paths above, whose walls they would inflate)
        for path in list(ref_paths.values()) + [replan_path, plain_path]:
            if os.path.exists(path):
                os.remove(path)
        children = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference",
             path, case], cwd=ROOT) for case, path in ref_paths.items()]
        children.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-replan",
             replan_path], cwd=ROOT))

        # ---- 3. kernels against their plain versions ---------------------------
        plains = {"fused_factor": cuda_fused.fused_factor_plain,
                  "tridiag_solve": cuda_kkt.tridiag_solve_plain,
                  "cho_solve_vec": cuda_kkt.cho_solve_vec_plain,
                  "chol": cuda_kkt.chol_plain,
                  "cho_solve": cuda_kkt.cho_solve_plain,
                  "tridiag_factor": cuda_kkt.tridiag_factor_plain,
                  "fused_chol_solve": cuda_kkt.fused_chol_solve_plain}
        # cho_solve's calls as the IPM makes them (L a slice of one factor,
        # B a transposed view), for phase 5 and --save-captures
        cho_raw = {"replan path": (rcaps["cho_solve"].first,
                                   rcaps["cho_solve"].late),
                   "penalized path": (pcaps["cho_solve"].first,
                                      pcaps["cho_solve"].late)}
        # chol and cho_solve factor and solve stage blocks, on one lane or
        # on a sweep's B lanes: hold them block by block
        for c in (rcaps["chol"], rcaps["cho_solve"], pcaps["chol"],
                  pcaps["cho_solve"]):
            c.first = _blockwise(c.first)
            c.late = [_blockwise(a) for a in c.late]
        print("checks: readings are fractions of their bounds (<= 1), the "
              "largest over the calls and over the lanes where success in the "
              "dtype is guaranteed")
        max_abs, all_checks, failed = {}, {}, []
        dcap = caps["discretize_lanes"]
        phases = [(name, cap, "first IPM iteration",
                   f"SCvx iteration {LATE_LOCKSTEP}")
                  for name, cap in caps.items() if cap is not dcap]
        phases += [(name, cap, "first IPM iteration of the cold replan solve",
                    "last replan iteration") for name, cap in rcaps.items()]
        phases += [(name, cap, "first IPM iteration of the penalized path",
                    f"penalized path, SCvx iteration {LATE_LOCKSTEP}")
                   for name, cap in pcaps.items()]
        phases += [(name, cap, "first IPM iteration of the point-mass path",
                    f"point-mass path, SCvx iteration {LATE_LOCKSTEP}")
                   for name, cap in mcaps.items() if name != "discretize_lanes"]
        # the seeded path's nominal (B=1) and the STC solve (R one larger)
        phases += [(name, cap, "first IPM iteration of the seeded path's "
                    "nominal, B=1", None) for name, cap in ncaps.items()]
        phases.append(("fused_factor", stc_cap, "first IPM iteration of the "
                       "STC solve", f"STC solve, SCvx iteration "
                       f"{LATE_LOCKSTEP} (or its last)"))
        # fused_chol_solve is on no path: synthetic SPD batches, float64, at
        # the vehicle's shape and at the penalized path's stage Hessian's
        # (H and E' of every node of the B=256, K=50 sweep)
        synth6 = {}
        for shape in (VEHICLE, (MAIN_B * MAIN_K, 17, 13)):
            N6, n6, m6 = shape
            R6 = torch.randn(N6, n6, n6, generator=gen, dtype=torch.float64)
            synth6[shape] = (
                (R6 @ _T(R6) + n6 * torch.eye(n6, dtype=torch.float64)).cuda(),
                torch.randn(N6, n6, m6, generator=gen, dtype=torch.float64).cuda())
        checks = [(name, first_when, cap.first, late_when, cap.late)
                  for name, cap, first_when, late_when in phases]
        (v_shape, v_args), (s_shape, s_args) = synth6.items()
        checks.append(("fused_chol_solve", f"synthetic SPD {v_shape}", v_args,
                       f"synthetic SPD {s_shape}", [s_args]))
        # the generic-width kernels (n not compiled in) at a ragged N
        Ag = _sparse_spd(gen, GENERIC_CHOL[0], GENERIC_CHOL[1]).cuda()
        Nf, nf, mf = GENERIC_FCS
        fg_args = (_sparse_spd(gen, Nf, nf).cuda(), torch.randn(
            Nf, nf, mf, generator=gen, dtype=torch.float64).cuda())
        checks.append(("chol", f"synthetic SPD {GENERIC_CHOL}, generic width",
                       (Ag,), None, None))
        checks.append(("fused_chol_solve", f"synthetic SPD {GENERIC_FCS}, "
                       "generic width", fg_args, None, None))
        for name, first_when, first, late_when, late in checks:
            # every call of the late iteration, but every third for
            # tridiag_solve (its dense forward bound is costly; 3 is prime
            # to its 4 calls an IPM iteration, so every kind of solve is held)
            if name == "tridiag_solve":
                late = late[::3]
            for when, calls in ((first_when, [first]), (late_when, late)):
                if when is None:   # a synthetic check of one call
                    continue
                if not calls or calls[0] is None:
                    raise PhaseError(f"{name}: no captured call for {when}")
                before = wrappers[name].launches
                res = [check_call(name, a, wrappers[name], plains[name])
                       for a in calls]
                if wrappers[name].launches != before + 2 * len(calls):
                    raise PhaseError(f"{name}: a kernel call did not count one launch")
                all_checks[f"{name} / {when}"] = res
                if when == first_when:
                    # the first path's reading: main, replan, penalized
                    max_abs.setdefault(name, res[0]["max_abs_err"])
                top = lambda key: max(r[key] for r in res)  # noqa: E731
                tot = lambda key: sum(r[key] for r in res)  # noqa: E731
                reads = "; ".join(f"{key} {top(key):.3f}" for key in res[0]
                                  if key.startswith(("fwd_", "bwd_")))
                n_bad = sum(not r["ok"] for r in res)
                print(f"check {name} ({when}, {len(res)} call(s) of "
                      f"{res[0]['lanes']} lanes, shapes "
                      f"{[tuple(a.shape) for a in calls[0]]}): lane-calls with "
                      f"the reference finite {tot('ref_finite')}, success "
                      f"guaranteed f32 {tot('f32_guaranteed')} / f64 "
                      f"{tot('f64_guaranteed')}; finite in plain f32 "
                      f"{tot('plain32_finite')}, kernel f32 "
                      f"{tot('kernel32_finite')}, kernel f64 "
                      f"{tot('kernel64_finite')}; guaranteed lanes lost by the "
                      f"kernel f32 {tot('kernel32_lost')} (by plain f32 "
                      f"{tot('plain32_lost')}), by the kernel f64 "
                      f"{tot('kernel64_lost')}; {reads} -> "
                      f"{'ok' if n_bad == 0 else f'FAIL in {n_bad}'}")
                if n_bad:
                    failed.append(f"{name} ({when})")
        # discretize: the main path's first and 10th lockstep calls, each
        # replan run's last linearization, and the first call again with
        # drag in every scenario but the first and a NaN node (its lane
        # must come out NaN)
        m, prm, X0, U0, s0, sub, foh = dcap.first
        Xn = X0.clone()
        Xn[1, 3] = float("nan")
        synth = (m, prm.replace(cd_a=torch.linspace(
            0.0, 0.3, X0.shape[0], dtype=X0.dtype, device=X0.device)),
            Xn, U0, s0, sub, foh)
        print(f"check discretize_lanes gates, per lane and output "
              f"{'/'.join(DISC_OUT)}: f64 kernel within {DISC_F64_ULPS} f64 "
              f"ulps of the f64 plain, normwise; f32 kernel within "
              f"{DISC_F32_FACTOR}x the f32 plain's distance from it (floor "
              f"{DISC_F32_FLOOR_ULPS} f32 ulps); finite in exactly the lanes "
              "where the f64 plain is")
        mcap = mcaps["discretize_lanes"]
        Xm = mcap.first[2].clone()
        Xm[1, 3] = float("nan")
        synth_m = mcap.first[:2] + (Xm,) + mcap.first[3:]
        PD = PM_DISC
        for key, when, a in (
                ("discretize_lanes", "main path, first SCvx iteration",
                 dcap.first),
                ("discretize_lanes", f"main path, SCvx iteration {LATE_LOCKSTEP}",
                 dcap.late[0] if dcap.late else None),
                ("discretize_lanes", "replan path, last iteration",
                 rdcap.late[0] if rdcap.late else None),
                ("discretize_lanes", f"replan path at static_reg "
                 f"{REPLAN_CHECK_REG:g}, last iteration",
                 rdcap6.late[0] if rdcap6.late else None),
                ("discretize_lanes", "synthetic: drag, one NaN node", synth),
                ("discretize_lanes", "drag solve (lanes with cd_a 0 and "
                 "0.05), first SCvx iteration", ddcap.first),
                (PD, "point-mass path, first SCvx iteration", mcap.first),
                (PD, f"point-mass path, SCvx iteration {LATE_LOCKSTEP} (or "
                 "its last)", mcap.late[-1] if mcap.late else None),
                (PD, "point-mass synthetic: one NaN node", synth_m)):
            if a is None:
                raise PhaseError(f"discretize_lanes: no captured call for {when}")
            before = cuda_disc.discretize_lanes.launches
            res = check_disc(a, cuda_disc.discretize_lanes,
                             cuda_disc.discretize_lanes_plain)
            if cuda_disc.discretize_lanes.launches != before + 2:
                raise PhaseError("discretize_lanes: a kernel call did not count "
                                 "one launch")
            # the merit's end states (plain propagate) beside the kernel's:
            # rounding-order apart, a reading and not a gate
            x_lin = disc_mod.discretize(*a).x_prop
            x_nl = disc_mod.propagate(*a)
            gap = (x_lin.double() - x_nl.double()).reshape(-1, x_nl.shape[-1])
            fin = torch.isfinite(gap).all(1)
            res["x_prop_gap_l1"] = float(gap[fin].abs().sum())
            res["x_prop_gap_ulps"] = float(
                (gap.norm(dim=1) / (x_nl.double().reshape(gap.shape).norm(
                    dim=1) * 2.0 ** -24).clamp(min=1e-300))[fin].max())
            res["defect_l1"] = float((x_nl - a[2][..., 1:, :]).reshape(
                gap.shape)[fin].abs().sum())
            all_checks[f"{key} / {when}"] = [res]
            max_abs.setdefault(key, res["max_abs_err"])
            reads = "; ".join(
                f"{o} {res[o + '_f64']:.3f}/{res[o + '_f32']:.3f} (ulps f64 "
                f"{res[o + '_ulps64']:.1f}, f32 kernel "
                f"{res[o + '_ulps32_kernel']:.1f} plain "
                f"{res[o + '_ulps32_plain']:.1f})" for o in DISC_OUT)
            print(f"check {key} ({when}, {res['lanes']} lanes, X "
                  f"{tuple(a[2].shape)}): reference finite in "
                  f"{res['ref_finite']}, plain f32 {res['plain32_finite']}, "
                  f"kernel f32 {res['kernel32_finite']}, f64 "
                  f"{res['kernel64_finite']} (mismatches "
                  f"{res['kernel_finite_mismatch']}); readings f64/f32: {reads}"
                  f"; kernel x_prop - plain propagate: l1 "
                  f"{res['x_prop_gap_l1']:.3e} (plain defect l1 "
                  f"{res['defect_l1']:.3e}), at most "
                  f"{res['x_prop_gap_ulps']:.1f} f32 ulps normwise a lane -> "
                  f"{'ok' if res['ok'] else 'FAIL'}")
            if not res["ok"]:
                failed.append(f"{key} ({when})")
        # chol, fused_chol_solve and tridiag_factor at an infinite and at a
        # negative pivot (synthetic): factor on, or NaN, where the plain
        # versions do
        piv, piv_ok = check_pivots(cuda_kkt)
        all_checks["pivots"] = piv
        print(f"check pivots (an infinite and a negative pivot; chol and "
              f"fused_chol_solve on 8 blocks of n=17, tridiag_factor on "
              f"{TRIFAC_PIVOTS[:3]} at node {TRIFAC_PIVOTS[3]}; against the "
              "float64 plain versions on the CPU: the same non-finite "
              "entries, the rest within the forward gate or bit-equal): "
              + "; ".join(f"{k} fwd {v['fwd_kernel']:.3f} (plain on the card "
                          f"non-finite as the reference: "
                          f"{v['card_plain_as_cpu']}) "
                          f"{'ok' if v['ok'] else 'FAIL'}"
                          for k, v in piv.items()))
        if not piv_ok:
            failed.append("pivots")
        with open(os.path.join(ROOT, "build", "chip_smoke_checks.json"), "w") as f:
            json.dump(all_checks, f)
        if failed:
            raise PhaseError(f"kernels disagree with their plain versions: {failed}")

        # the wrappers refuse what their kernels do not take
        dev = "cuda"
        refusals = (
            ("float16", TypeError, lambda: cuda_kkt.cho_solve_vec(
                torch.eye(4, dtype=torch.float16, device=dev).expand(2, 4, 4),
                torch.zeros(2, 4, dtype=torch.float16, device=dev))),
            ("n = 40 > 32", ValueError, lambda: cuda_kkt.cho_solve_vec(
                torch.eye(40, dtype=torch.float64, device=dev)[None],
                torch.zeros(1, 40, dtype=torch.float64, device=dev))),
            ("CPU and CUDA tensors mixed", ValueError, lambda: cuda_kkt.tridiag_solve(
                torch.eye(3, device=dev).expand(1, 2, 3, 3),
                torch.zeros(1, 2, 3, 3), torch.zeros(1, 2, 3, device=dev))),
            ("chol float16", TypeError, lambda: cuda_kkt.chol(
                torch.eye(4, dtype=torch.float16, device=dev)[None])),
            ("chol n = 33 > 32", ValueError, lambda: cuda_kkt.chol(
                torch.eye(33, device=dev)[None])),
            ("cho_solve m = 33 > 32", ValueError, lambda: cuda_kkt.cho_solve(
                torch.eye(4, device=dev)[None], torch.zeros(1, 4, 33, device=dev))),
            ("cho_solve CPU and CUDA tensors mixed", ValueError,
             lambda: cuda_kkt.cho_solve(torch.eye(4, device=dev)[None],
                                        torch.zeros(1, 4, 3))),
            ("cho_solve B's columns strided (a layout it does not read)",
             ValueError, lambda: cuda_kkt.cho_solve(
                 torch.eye(4, device=dev).expand(2, 4, 4).contiguous(),
                 torch.zeros(2, 4, 6, device=dev)[..., ::2])),
            ("cho_solve L's blocks column-major (a layout it does not read)",
             ValueError, lambda: cuda_kkt.cho_solve(
                 torch.eye(4, device=dev).expand(2, 4, 4).contiguous()
                 .transpose(-1, -2), torch.zeros(2, 4, 3, device=dev))),
            ("discretize_lanes float16", TypeError, lambda: cuda_disc.discretize_lanes(
                *_disc_cast(dcap.first, torch.float16))),
            ("discretize_lanes CPU and CUDA tensors mixed", ValueError,
             lambda: cuda_disc.discretize_lanes(
                 m, prm, X0, U0.cpu(), s0, sub, foh)),
            ("discretize_lanes, a model without CUDA dynamics", ValueError,
             lambda: cuda_disc.discretize_lanes(dataclasses.replace(
                 m, name="no_cuda_dynamics", cuda_dynamics=None),
                 prm, X0, U0, s0, sub, foh)),
            ("discretize_lanes pointmass3dof float16", TypeError,
             lambda: cuda_disc.discretize_lanes(
                 *_disc_cast(mcap.first, torch.float16))),
            ("tridiag_factor float16", TypeError, lambda: cuda_kkt.tridiag_factor(
                torch.eye(4, dtype=torch.float16, device=dev).expand(1, 2, 4, 4),
                torch.zeros(1, 1, 4, 4, dtype=torch.float16, device=dev))),
            ("tridiag_factor n = 33 > 32", ValueError,
             lambda: cuda_kkt.tridiag_factor(
                 torch.eye(33, device=dev).expand(1, 2, 33, 33),
                 torch.zeros(1, 1, 33, 33, device=dev))),
            ("tridiag_factor CPU and CUDA tensors mixed", ValueError,
             lambda: cuda_kkt.tridiag_factor(
                 torch.eye(4, device=dev).expand(1, 2, 4, 4),
                 torch.zeros(1, 1, 4, 4))),
            ("tridiag_factor O with the wrong block count", ValueError,
             lambda: cuda_kkt.tridiag_factor(
                 torch.eye(4, device=dev).expand(1, 3, 4, 4),
                 torch.zeros(1, 3, 4, 4, device=dev))),
            ("fused_chol_solve float16", TypeError,
             lambda: cuda_kkt.fused_chol_solve(
                 torch.eye(4, dtype=torch.float16, device=dev)[None],
                 torch.zeros(1, 4, 2, dtype=torch.float16, device=dev))),
            ("fused_chol_solve m = 33 > 32", ValueError,
             lambda: cuda_kkt.fused_chol_solve(
                 torch.eye(4, device=dev)[None],
                 torch.zeros(1, 4, 33, device=dev))),
        )
        for what, exc, call in refusals:
            try:
                call()
            except exc:
                continue
            raise PhaseError(f"a wrapper took what its kernel does not ({what})")
        print(f"wrappers refuse: {', '.join(w for w, _, _ in refusals)} -> ok")

        if save_captures:
            # the inputs scripts/kernel_ab.py holds tridiag_factor,
            # cho_solve_vec, chol, cho_solve and discretize_lanes to a parent's
            # kernels on (on the card); a discretize call as (model name,
            # params fields, X, U, sigma, substeps, foh)
            late = LATE_LOCKSTEP
            cv = caps["cho_solve_vec"]

            def disc_saved(a):
                mdl, prm_, *rest = a
                return (mdl.cuda_dynamics.name, prm_.fields(), *rest)

            torch.save({
                "cho_solve": [
                    (f"{where}, {when}", a)
                    for where, (first, calls) in cho_raw.items()
                    for when, a in [("first", first)] + [
                        (f"late call {i}", c) for i, c in enumerate(calls)
                        if i % 8 == 0]],
                "discretize_lanes": [
                    (f"{where}, {when}", disc_saved(a))
                    for where, c in (("main path", dcap),
                                     ("replan path", rdcap),
                                     ("penalized path", pdcap),
                                     ("point-mass path", mcap))
                    for when, a in (("first", c.first),
                                    ("late", c.late[0] if c.late else None))
                    if a is not None],
                "chol": [
                    (f"{where}, {when}", a)
                    for where, c in (("replan path", rcaps["chol"]),
                                     ("penalized path", pcaps["chol"]))
                    for when, a in [("first", c.first)] + [
                        (f"late call {i}", x) for i, x in enumerate(c.late)
                        if i % 4 == 0]],
                "tridiag_factor": [("penalized path, first", pcaps[
                    "tridiag_factor"].first)] + [
                    (f"penalized path, SCvx iteration {late}, call {i}", a)
                    for i, a in enumerate(pcaps["tridiag_factor"].late)
                    if i % 4 == 0],
                "cho_solve_vec": [("main path, first", cv.first)] + [
                    (f"main path, SCvx iteration {late}, call {i}", a)
                    for i, a in enumerate(cv.late) if i % 16 == 0] + [
                    (f"{where}, first", c["cho_solve_vec"].first)
                    for c, where in ((rcaps, "replan path"),
                                     (pcaps, "penalized path"),
                                     (mcaps, "point-mass path"))]},
                save_captures)
            print(f"captured inputs of tridiag_factor, cho_solve_vec, chol, "
                  f"cho_solve and discretize_lanes saved to {save_captures}")

        # ---- 5. times at each path's shapes -----------------------------------
        library = {
            "cho_solve_vec": lambda L, b: torch.cholesky_solve(b[..., None], L),
            "chol": lambda A: torch.linalg.cholesky_ex(A),
            "cho_solve": lambda L, B: torch.cholesky_solve(B, L),
            "fused_chol_solve": lambda A, B: torch.linalg.solve(A, B)}
        records = []
        plains["discretize_lanes"] = cuda_disc.discretize_lanes_plain
        wrappers[PM_DISC] = wrappers["discretize_lanes"]
        plains[PM_DISC] = plains["discretize_lanes"]
        max_abs["fused_chol_solve"] = all_checks[
            f"fused_chol_solve / synthetic SPD {v_shape}"][0]["max_abs_err"]
        timed = [(name, cap.first, launches[name], "main path")
                 for name, cap in caps.items()]
        timed.append(("discretize_lanes", rdcap.late[0], None, "replan path"))
        timed += [(name, rcaps[name].first, rlaunches[name], "replan path")
                  for name in ("chol", "cho_solve")]
        # cho_solve on the penalized path's call as the IPM makes it: L
        # chol_Hw[:, :-1] of B=256 lanes (a lane stride), B = E'
        timed.append(("cho_solve", cho_raw["penalized path"][0], None,
                      "penalized path, read in place"))
        # ... which it reads in place: its one device operation is the
        # kernel, no copy of L or B before it (traced in a child process)
        prof_path = os.path.join(ROOT, "build", "chip_smoke_cho_solve_calls.pt")
        torch.save({where: first for where, (first, _) in cho_raw.items()},
                   prof_path)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--profile-cho-solve", prof_path], cwd=ROOT,
                            timeout=600).returncode
        if rc != 0 or not os.path.exists(prof_path + ".json"):
            raise PhaseError(f"cho_solve profile child failed (rc={rc})")
        for where, res in json.load(open(prof_path + ".json")).items():
            ops = res["ops"]
            print(f"profile of one cho_solve call ({where}, shapes "
                  f"{res['shapes']}, strides {res['strides']}): device "
                  f"operations {ops}")
            if len(ops) != 1 or "cho_solve_kernel" not in ops[0]:
                raise PhaseError(f"cho_solve ({where}): device operations "
                                 f"besides its kernel: {ops}")
        # chol and cho_solve also at a B=256 batch of the replan blocks
        timed += [(name, tuple(a.repeat(MAIN_B, *([1] * (a.dim() - 1)))
                               for a in rcaps[name].first), None, "B=256 batch")
                  for name in ("chol", "cho_solve")]
        timed.append(("tridiag_factor", pcaps["tridiag_factor"].first,
                      plaunches["tridiag_factor"], "penalized path"))
        timed.append(("tridiag_factor", tuple(
            a.double() for a in pcaps["tridiag_factor"].first), None,
            "penalized path, float64"))
        # cho_solve_vec at every path's shapes: replan (N=50), penalized
        # (12,800) and point mass (7,680 blocks of n=11)
        timed += [("cho_solve_vec", c["cho_solve_vec"].first, None, where)
                  for c, where in ((rcaps, "replan path"),
                                   (pcaps, "penalized path"),
                                   (mcaps, "point-mass path"))]
        # the two redesigned kernels at their other paths' shapes, for the
        # record: tridiag_solve on the penalized path, both at the point
        # mass's (K=30, nrx=7)
        timed.append(("tridiag_solve", pcaps["tridiag_solve"].first, None,
                      "penalized path"))
        timed += [(name, mcaps[name].first, None, "point-mass path")
                  for name in ("fused_factor", "tridiag_solve")]
        timed.append((PM_DISC, mcap.first, mlaunches["discretize_lanes"],
                      "point-mass path"))
        # fused_chol_solve in float32: its vehicle's shape (the record; its
        # launch is the vehicle's, phase 2e) and the stage-Hessian shape
        timed.append(("fused_chol_solve", tuple(a.float() for a in v_args),
                      vlaunches["fused_chol_solve"], "vehicle"))
        timed.append(("fused_chol_solve", tuple(a.float() for a in s_args),
                      None, "penalized path's stage Hessian shape"))
        # chol's generic-width kernel (n = 20 not compiled in), f32
        timed.append(("chol", (Ag.float(),), None, "generic width"))
        # fused_factor at the seeded nominal's B=1 and at the STC solve's R
        timed.append(("fused_factor", ncaps["fused_factor"].first, None,
                      "seeded path's nominal, B=1"))
        timed.append(("fused_factor", stc_cap.first, None,
                      f"STC solve, R = {r_stc}, float64"))
        for name, args, n_launch, where in timed:
            ms, plain_ms, lib_ms, rec = _time_kernel(
                name, args, wrappers[name], plains[name], library.get(name))
            if n_launch is not None:
                records.append({"name": name, "route": "cuda", **KERNELS[name],
                                "launches": n_launch,
                                "max_abs_err": max_abs[name],
                                **{k: v for k, v in rec.items()
                                   if k not in ("mbytes", "gflop")}})
            first = ""
            if where == "generic width":
                first = (f", the first design "
                         f"{GENERIC_CHOL_FIRST_DESIGN_MS} ms at this shape "
                         f"(scripts/kernel_ab.py)")
            print(f"time {name} ({where}) at "
                  f"{[tuple(a.shape) for a in args if torch.is_tensor(a)]}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                  f"{rec['bound_ms']:.5f} ms by {rec['bound_by']} "
                  f"({rec['mbytes']:.3f} MB, {rec['gflop']:.5f} GFLOP){first}; "
                  f"{card}")

        # the A/B: one discretize call at B=256 (the main path's first),
        # synchronized, the kernel against the plain version, in turns
        walls = {"kernel": [], "plain": []}
        kernel_fn = cuda_disc.discretize_lanes
        for rep_i in range(5):
            for which in (("kernel", "plain") if rep_i % 2 == 0
                          else ("plain", "kernel")):
                cuda_disc.discretize_lanes = (
                    kernel_fn if which == "kernel"
                    else cuda_disc.discretize_lanes_plain)
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    disc_mod.discretize(m, prm, X0, U0, s0, sub, foh)
                    torch.cuda.synchronize()
                finally:
                    cuda_disc.discretize_lanes = kernel_fn
                walls[which].append(1e3 * (time.perf_counter() - t0))
        med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
        print(f"A/B discretize at B={X0.shape[0]}, K={X0.shape[1]}, {sub} "
              f"substeps, float32, synchronized wall, median of 5 in turns: "
              f"kernel {med['kernel']:.3f} ms, plain {med['plain']:.3f} ms "
              f"({med['plain'] / med['kernel']:.1f}x); all kernel "
              f"{[round(w, 3) for w in walls['kernel']]}, plain "
              f"{[round(w, 1) for w in walls['plain']]}; {card}")

        # ---- 4. f64 on the card against the CPU -------------------------------
        # phase 2h, the sharded sweep on the card, in children started first
        # beside the card runs below: (a) run_batch against solve_batch at
        # the main path's width, (b) the point-mass crash and resume and (c)
        # the CLI's distributed sweep and its resume
        h_paths = {k: os.path.join(ROOT, "build", f"chip_smoke_2h_{k}.json")
                   for k in ("a", "bc")}
        h_children = {}
        for k, mode in (("a", "--sharded-sweep"), ("bc", "--sharded-resume")):
            if os.path.exists(h_paths[k]):
                os.remove(h_paths[k])
            with open(h_paths[k].replace(".json", ".log"), "w") as log:
                h_children[k] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), mode,
                     h_paths[k]], cwd=ROOT, stdout=log,
                    stderr=subprocess.STDOUT)
            children.append(h_children[k])
        # phase 2i, the ksharded KKT backend on the card, in a child beside
        # them: (a) the JAX test's subproblem, (b) a ksharded scvx_solve and
        # (c) its launches, (d) kernels 5 and 2 on (b)'s calls
        k_path = os.path.join(ROOT, "build", "chip_smoke_2i.json")
        if os.path.exists(k_path):
            os.remove(k_path)
        with open(k_path.replace(".json", ".log"), "w") as log:
            k_child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ksharded",
                 k_path], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        children.append(k_child)
        # phase 2j, the Gondzio correctors and the host-compacting sweep on
        # the card, in a child beside them
        j_path = os.path.join(ROOT, "build", "chip_smoke_2j.json")
        if os.path.exists(j_path):
            os.remove(j_path)
        with open(j_path.replace(".json", ".log"), "w") as log:
            j_child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--gondzio-host",
                 j_path, main_state], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT)
        children.append(j_child)
        # the penalized case with the plain factor on the card, a reading, in
        # a child beside the card runs below (after phase 5: it would share
        # the card with the timed kernels)
        children.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--card-plain-factor",
             plain_path], cwd=ROOT))
        # phase 2g (c) and (d): the CLI on the card, in children beside the
        # card runs below: the STC solve of (a) at its settings as dotted
        # overrides, and a seeded sweep of 8 lanes at K=14 with metrics and
        # a checkpoint
        for q in (cli_out["stc.npz"], cli_out["sweep.jsonl"],
                  cli_out["ck"] + ".npz"):
            if os.path.exists(q):
                os.remove(q)
        cli = [sys.executable, "-m", "successiveconvexification_tpu_torch.cli"]
        cli_args = {
            "solve": ["solve", "--model", "rocket6dof_stc", "--dtype", "float64",
                      f"--disc.K={ATMO_K}", "--disc.substeps=5",
                      "--ipm.max_iters=30", "--ipm.refine_steps=2",
                      "--scvx.max_iters=45", "--out", cli_out["stc.npz"]],
            "sweep": ["sweep", "--seeded", "--batch", "8",
                      f"--disc.K={ATMO_K}", "--metrics", cli_out["sweep.jsonl"],
                      "--checkpoint", cli_out["ck"]]}
        cli_logs = {k: os.path.join(ROOT, "build", f"chip_smoke_cli_{k}.log")
                    for k in cli_args}
        cli_children = {}
        for k, a in cli_args.items():
            with open(cli_logs[k], "w") as log:
                cli_children[k] = subprocess.Popen(
                    cli + a, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
            children.append(cli_children[k])
        # the f64 card runs, each in a child of its own beside the others
        # (host-bound: one after another they took 442 of 1,292 s on an
        # H100 at 700 W)
        for case, q in card_paths.items():
            if os.path.exists(q):
                os.remove(q)
            children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--card-reference",
                 q, case], cwd=ROOT))
        # (d)'s reference: the CLI's sweep, in this process
        cfg_cli = P.SolverConfig(disc=P.DiscretizationConfig(K=ATMO_K))
        p32 = rk.default_params(torch.float32, "cuda")
        ref8 = P.solve_batch_seeded(
            model, P.sample_dispersions(
                p32, torch.Generator(device="cpu").manual_seed(0), 8),
            cfg_cli, nominal_params=p32, device="cuda")
        cfg64r = _configs(P, "float64", MAIN_K, MAIN_SUBSTEPS, bench=False,
                          kkt="pcr", static_reg=REPLAN_CHECK_REG)
        t0 = time.perf_counter()
        card_r = _replan_summary(replan(P, model, cfg64r, "cuda",
                                        cfg64r.scvx.max_iters))
        card_r_s = time.perf_counter() - t0
        rcs = [c.wait(timeout=900) for c in children]
        children = []
        for k, c in cli_children.items():
            print(f"CLI {k} child (exit code {c.returncode}): "
                  + " ".join(open(cli_logs[k]).read().split())[-600:])
        for k, c in h_children.items():
            if c.returncode:
                print(f"2h {k} child (exit code {c.returncode}): " + " ".join(
                    open(h_paths[k].replace(".json", ".log")).read().split()
                )[-1500:])
        for name, c, q in (("2i", k_child, k_path), ("2j", j_child, j_path)):
            if c.returncode:
                print(f"{name} child (exit code {c.returncode}): " + " ".join(
                    open(q.replace(".json", ".log")).read().split())[-1500:])
        paths = list(ref_paths.values()) + list(card_paths.values())
        paths += [replan_path, plain_path, cli_out["stc.npz"],
                  cli_out["sweep.jsonl"], cli_out["ck"] + ".npz"]
        paths += list(h_paths.values()) + [k_path, j_path]
        if any(rcs) or not all(os.path.exists(q) for q in paths):
            raise PhaseError(f"f64 reference runs or CLI children failed "
                             f"(rc={rcs})")
        card64 = {case: json.load(open(q)) for case, q in card_paths.items()}
        card_s = {case: r["seconds"] for case, r in card64.items()}
        cpu_r = json.load(open(replan_path))
        import numpy as np
        from successiveconvexification_tpu_torch.io import checkpoint
        from successiveconvexification_tpu_torch.utils.tree import tree_leaves

        sig_cli = float(np.load(cli_out["stc.npz"])["sigma"])
        rel_cli = abs(sig_cli - float(stc.sigma[0])) / abs(float(stc.sigma[0]))
        lines = [json.loads(x) for x in open(cli_out["sweep.jsonl"])]
        keys_ok = (len(lines) == 2 and "_manifest" in lines[0]
                   and set(lines[1]) == CLI_SWEEP_KEYS
                   and lines[1]["n_total"] == 8
                   and lines[0]["_manifest"]["devices"] == [kind])
        back = checkpoint.restore(cli_out["ck"], ref8, cfg=cfg_cli)
        n_same = sum(torch.equal(_bits(a), _bits(b)) for a, b in
                     zip(tree_leaves(back), tree_leaves(ref8)))
        n_leaves = len(tree_leaves(ref8))
        print(f"CLI on the card: solve --model rocket6dof_stc sigma "
              f"{sig_cli:.9f} against the STC solve's, relative diff "
              f"{rel_cli:.3e} (tol 1e-6); sweep --seeded --batch 8: record "
              f"{json.dumps(lines[-1])}, manifest and keys "
              f"{'ok' if keys_ok else 'WRONG'}; checkpoint restored against "
              f"an in-process run of the same lanes: {n_same}/{n_leaves} "
              f"leaves equal bit for bit")
        if not (rel_cli <= 1e-6 and keys_ok and n_same == n_leaves):
            raise PhaseError("CLI children disagree with the in-process runs")
        check_sharded(json.load(open(h_paths["a"])),
                      json.load(open(h_paths["bc"])), card)
        check_ksharded(json.load(open(k_path)), r, {
            "sigma": float(nominal.sigma[0]),
            "iterations": int(nominal.iterations[0]), "wall": nominal_s},
            card64["seeded"]["nominal"]["sigma"][0], card)
        check_gondzio_host(json.load(open(j_path)), r, {
            "sigma": float(nominal.sigma[0]),
            "iterations": int(nominal.iterations[0]), "wall": nominal_s,
            "ipm_iterations": nlaunches["fused_factor"] - ncounts["cold"]},
            card64["seeded"]["nominal"]["sigma"][0], main_counts, card)

        def rel_diff(a, b):
            """max |a - b| over max |b| (normwise, arrays or lists)."""
            a, b = torch.tensor(a, dtype=torch.float64), torch.tensor(b, dtype=torch.float64)
            return float((a - b).abs().max() / b.abs().max())

        for case, path in ref_paths.items():
            cpu, card_c = json.load(open(path)), card64[case]
            # the fixed-time point mass pins sigma: compare the trajectory
            keys = ("X", "U") if case == "pointmass" else ("sigma",)
            if case == "pointmass":
                rel = max(rel_diff(card_c[k], cpu[k]) for k in keys)
            else:
                rel = max(abs(a - b) / abs(b) for a, b in zip(card_c["sigma"],
                                                             cpu["sigma"]))
            same = all(card_c[k] == cpu[k] for k in ("iterations", "converged"))
            if case == "seeded":   # and its nominal
                cn, pn = card_c["nominal"], cpu["nominal"]
                rel = max(rel, abs(cn["sigma"][0] - pn["sigma"][0])
                          / abs(pn["sigma"][0]))
                same &= all(cn[k] == pn[k] for k in ("iterations", "converged"))
                print(f"f64 seeded nominal: iterations card {cn['iterations']} "
                      f"CPU {pn['iterations']}, sigma card {cn['sigma'][0]:.9f} "
                      f"CPU {pn['sigma'][0]:.9f}")
            K64 = PM_K if case == "pointmass" else MAIN_K
            print(f"f64 {case} B={REF_B} K={K64}: card {card_s[case]:.1f} s, "
                  f"CPU {cpu['seconds']:.1f} s; iterations card "
                  f"{card_c['iterations']} CPU {cpu['iterations']}; converged "
                  f"{card_c['converged']}; {'/'.join(keys)} max rel diff "
                  f"{rel:.3e} (tol 1e-6)")
            if not (rel <= 1e-6 and same):
                raise PhaseError(f"f64 card run ({case}) disagrees with the CPU run")
        cpu_p = json.load(open(ref_paths["penalized"]))
        card_pp = json.load(open(plain_path))

        def sig_gaps(a, b):
            return [f"{abs(x - y) / abs(y):.3e}"
                    for x, y in zip(a["sigma"], b["sigma"])]

        print(f"  f64 penalized B={REF_B}, tridiag_factor's plain version on "
              f"the card ({card_pp['seconds']:.1f} s): iterations "
              f"{card_pp['iterations']}, converged {card_pp['converged']}; "
              f"sigma relative gap to the CPU {sig_gaps(card_pp, cpu_p)}, "
              f"to the card with the kernel "
              f"{sig_gaps(card_pp, card64['penalized'])}, card with the kernel "
              f"to the CPU {sig_gaps(card64['penalized'], cpu_p)} (a reading: "
              "summation order alone)")
        # the seeded path against the cold one on the same lanes, f64, on the
        # card and on the CPU: tests/test_seeded.py's gate, sigma within 5e-2
        # where both converged
        for where, runs in (("card", card64), ("CPU", {
                c: json.load(open(ref_paths[c])) for c in ("main", "seeded")})):
            ds = [abs(a - b) for a, b, ca, cb in zip(
                runs["seeded"]["sigma"], runs["main"]["sigma"],
                runs["seeded"]["converged"], runs["main"]["converged"])
                if ca and cb]
            print(f"f64 seeded vs main path sigma on the {where}, lanes "
                  f"converged on both ({len(ds)}/{REF_B}): abs diffs "
                  f"{[f'{g:.3e}' for g in ds]} (gate 5e-2); mean iterations "
                  f"seeded {sum(runs['seeded']['iterations']) / REF_B:.2f}, "
                  f"main {sum(runs['main']['iterations']) / REF_B:.2f}")
            if len(ds) < REF_B or max(ds) >= 5e-2:
                raise PhaseError(f"f64 seeded path disagrees with the main "
                                 f"path on the {where}")
        both = [a and b for a, b in zip(card64["main"]["converged"],
                                        card64["penalized"]["converged"])]
        gap = [abs(p_ - m_) / abs(m_) for p_, m_, ok in zip(
            card64["penalized"]["sigma"], card64["main"]["sigma"], both) if ok]
        print(f"  f64 penalized vs main path sigma, lanes both converged: "
              f"relative gaps {[f'{g:.3e}' for g in gap]} (a reading)")
        rel_r = max(abs(card_r[k] - cpu_r[k]) / abs(cpu_r[k])
                    for k in ("cold_sigma", "sigma"))
        same_r = all(card_r[k] == cpu_r[k] for k in (
            "cold_iterations", "cold_converged", "iterations", "converged"))
        print(f"f64 replan K={MAIN_K} PCR, static_reg {REPLAN_CHECK_REG:g}: card "
              f"{card_r_s:.1f} s, CPU "
              f"{cpu_r['seconds']:.1f} s; cold iterations card "
              f"{card_r['cold_iterations']} CPU {cpu_r['cold_iterations']}, "
              f"replan iterations card {card_r['iterations']} CPU "
              f"{cpu_r['iterations']}; converged card "
              f"{card_r['cold_converged']}/{card_r['converged']} CPU "
              f"{cpu_r['cold_converged']}/{cpu_r['converged']}; sigma max rel "
              f"diff {rel_r:.3e} (tol 1e-6)")
        if not (rel_r <= 1e-6 and same_r):
            raise PhaseError("f64 card replan disagrees with the CPU replan")

        print(f"chip_smoke: all phases passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": records}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait()


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] in ("--cpu-reference",
                                              "--card-reference"):
        reference_child(sys.argv[2], sys.argv[3],
                        "cpu" if sys.argv[1] == "--cpu-reference" else "cuda")
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--cpu-replan":
        cpu_replan(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--card-plain-factor":
        card_plain_factor(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--profile-cho-solve":
        profile_cho_solve(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-sweep":
        sharded_sweep_child(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-resume":
        sharded_resume_child(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--ksharded":
        ksharded_child(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "--gondzio-host":
        gondzio_host_child(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if len(sys.argv) == 5 and sys.argv[1] == "--pm-run-batch":
        pm_run_batch_child(*sys.argv[2:])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--save-captures":
        sys.exit(main(sys.argv[2]))
    sys.exit(main())
