"""Command-line interface of the PyTorch port: single solves and sweeps.

Usage:
    python -m successiveconvexification_tpu_torch.cli solve
        [--model rocket6dof] [--config cfg.yaml] [--K 50] [--dtype float32]
        [--out traj.npz] [--plot fig.png] [--animate landing.gif]
        [--profile DIR] [--device cuda]
    python -m successiveconvexification_tpu_torch.cli sweep --batch 256
        [--seed 0] [--seeded] [--compact off|device|host] [--checkpoint ckpt]
        [--metrics metrics.jsonl] [--profile DIR] [--device cuda]
        [--distributed --coordinator HOST:PORT --num-processes N
         --process-id I [--ckpt-every 10] [--no-resume]]

Overrides use dotted flags: --ipm.max_iters=20 --scvx.w_nu=100 --disc.K=50.
Models: rocket6dof, rocket6dof_stc (the angle-of-attack constraint) and
pointmass3dof. ``--device`` defaults to the card; without one the CLI exits
with an error unless it is given ``--device cpu``. Each command prints one
JSON record, with the JAX package's CLI's keys. ``solve --plot`` and
``--animate`` draw the solution with ``utils/plotting.py``, which needs
matplotlib: without it the CLI exits with an error before it solves.

``sweep --distributed`` is the production multi-process sweep: start one
process a rank with the same flags and its own ``--process-id``. Each joins
the ``torch.distributed`` group at ``--coordinator`` before it touches a
device (NCCL on the card ``cuda:{process_id % device_count}``, gloo with
``--device cpu``), sweeps its tile of the lanes (``parallel/batch.py``
``run_batch``), commits ``{checkpoint}.shard{rank}.npz`` every
``--ckpt-every`` SCvx iterations, and on a restart resumes from the last
commit unless ``--no-resume``. Rank 0 writes the manifest and prints the
record, whose statistics are over the whole batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def _load_cfg(args, overrides):
    from successiveconvexification_tpu_torch.config import SolverConfig

    cfg = SolverConfig.from_yaml(args.config) if args.config else SolverConfig()
    d = cfg.to_dict()
    for key, val in overrides.items():
        parts = key.split(".")
        cur = d
        for p in parts[:-1]:
            cur = cur[p]
        leaf = parts[-1]
        if leaf not in cur:
            raise SystemExit(f"unknown config key: {key}")
        old = cur[leaf]
        cur[leaf] = type(old)(val) if old is not None and not isinstance(old, bool) \
            else (val in ("1", "true", "True")) if isinstance(old, bool) else val
    return SolverConfig.from_dict(d)


def _get_model(name: str, dtype, device):
    if name in ("rocket6dof", "rocket6dof_stc"):
        from successiveconvexification_tpu_torch.models import rocket6dof as m

        model = m.rocket6dof_model(aoa_stc=name.endswith("_stc"))
    elif name == "pointmass3dof":
        from successiveconvexification_tpu_torch.models import pointmass3dof as m

        model = m.pointmass3dof_model()
    else:
        raise SystemExit(f"unknown model {name}")
    return model, m.default_params(dtype=dtype, device=device)


def _split_overrides(argv):
    known, overrides = [], {}
    for a in argv:
        if a.startswith("--") and "." in a.split("=")[0]:
            k, _, v = a[2:].partition("=")
            overrides[k] = v
        else:
            known.append(a)
    return known, overrides


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(run, device, profile):
    """(result, seconds) of ``run()``; with ``profile``, one run first (it
    builds the kernels) and one under the profiler before the timed one."""
    if profile:
        from successiveconvexification_tpu_torch.utils.metrics import profile_trace

        run()
        _sync(device)
        with profile_trace(profile):
            run()
            _sync(device)
        print(f"profiler trace written to {profile}", file=sys.stderr)
    t0 = time.perf_counter()
    out = run()
    _sync(device)
    return out, time.perf_counter() - t0


def _need_matplotlib() -> None:
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"scvx: --plot and --animate need matplotlib, "
                         f"which is not installed ({e})") from None


def cmd_solve(args, overrides, device):
    from successiveconvexification_tpu_torch.ops.scvx import scvx_solve

    if args.plot or args.animate:
        _need_matplotlib()
    cfg = _load_cfg(args, overrides)
    if args.K:
        cfg = cfg.replace(disc=dataclasses.replace(cfg.disc, K=args.K))
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    model, params = _get_model(args.model, getattr(torch, cfg.dtype), device)
    st, dt = _timed(lambda: scvx_solve(model, params, cfg, device=device),
                    device, args.profile)
    X, U, sigma = st.X[0], st.U[0], st.sigma[0]   # the one lane
    out = {
        "model": args.model,
        "converged": bool(st.converged[0]),
        "iterations": int(st.iterations[0]),
        "sigma_tof": float(sigma),
        "final_mass": (float(X[-1, model.mass_index])
                       if model.mass_index is not None else None),
        "nu_norm": float(st.nu_norm[0]),
        "wall_s": round(dt, 3),
    }
    print(json.dumps(out, indent=2))
    if args.out:
        np.savez(args.out, X=X.cpu().numpy(), U=U.cpu().numpy(),
                 sigma=sigma.cpu().numpy())
        print(f"trajectory written to {args.out}")
    from successiveconvexification_tpu_torch.utils import plotting

    if args.plot:
        plotting.plot_trajectory(X, U, sigma, params=params, path=args.plot)
        print(f"plot written to {args.plot}")
    if args.animate:
        plotting.animate_trajectory(X, U, sigma, params=params,
                                    path=args.animate)
        print(f"animation written to {args.animate}")


def cmd_sweep(args, overrides, device):
    from successiveconvexification_tpu_torch.parallel import mesh as mesh_lib

    if not args.distributed:
        return _sweep(args, overrides, device, None)
    # the process group comes before any use of the device
    if device.type == "cuda":
        device = torch.device("cuda",
                              args.process_id % torch.cuda.device_count())
    mesh = mesh_lib.init_distributed(args.coordinator, args.num_processes,
                                     args.process_id, device)
    try:
        return _sweep(args, overrides, device, mesh)
    finally:
        mesh_lib.destroy_process_group()


def _sweep(args, overrides, device, mesh):
    import torch.distributed as dist

    from successiveconvexification_tpu_torch.io import checkpoint as ckpt
    from successiveconvexification_tpu_torch.parallel.batch import (
        batch_stats, run_batch, sample_dispersions, solve_batch,
        solve_batch_compact, solve_batch_compact_device, solve_batch_seeded,
    )
    from successiveconvexification_tpu_torch.utils.metrics import JsonlLogger

    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    cfg = _load_cfg(args, overrides)
    model, params = _get_model(args.model, getattr(torch, cfg.dtype), device)
    # every rank draws the whole batch from the seed and keeps its lanes
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    pb = sample_dispersions(params, gen, args.batch)
    names = [torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu"]
    if mesh is not None:
        names = names * world
        dist.all_gather_object(names, names[0], group=mesh.group)
    logger = JsonlLogger(args.metrics, manifest={
        "cmd": "sweep", "batch": args.batch, "seed": args.seed,
        "devices": names, "process": [rank, world], "config": cfg.to_dict(),
    }) if args.metrics and rank == 0 else None

    if mesh is not None:
        # the production path: the sharded sweep with periodic sharded
        # commits and a resume on restart
        def run():
            return run_batch(model, pb, cfg, mesh=mesh,
                             ckpt_path=args.checkpoint,
                             ckpt_every=args.ckpt_every,
                             resume=not args.no_resume, device=device)
    elif args.seeded:
        # one cold nominal solve, every dispersed lane warm-started from it
        # (STM-corrected), then the compacting sweep
        def run():
            return solve_batch_seeded(model, pb, cfg, nominal_params=params,
                                      device=device)
    elif args.compact == "device":
        def run():
            return solve_batch_compact_device(model, pb, cfg, device=device)
    elif args.compact == "host":
        def run():
            return solve_batch_compact(model, pb, cfg, device=device)
    else:
        def run():
            return solve_batch(model, pb, cfg, device=device)

    st, dt = _timed(run, device, args.profile)
    stats = batch_stats(st, mesh)
    rec = {
        "n_converged": int(stats.n_converged), "n_total": int(stats.n_total),
        "mean_iterations": float(stats.mean_iterations),
        "mean_sigma": float(stats.mean_sigma),
        "max_nu_norm": float(stats.max_nu_norm),
        "wall_s": round(dt, 3),
        "solves_per_s": round(args.batch / dt, 2),
    }
    if rank == 0:
        print(json.dumps(rec, indent=2))
    if logger:
        logger.log(rec)
        logger.close()
    if args.checkpoint and mesh is None:
        # a distributed run has committed its shard files in run_batch
        ckpt.save(args.checkpoint, st, cfg=cfg)
        print(f"sweep state checkpointed to {args.checkpoint}")


def main(argv=None):
    from successiveconvexification_tpu_torch.ops.precision import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    argv, overrides = _split_overrides(argv)
    p = argparse.ArgumentParser(prog="scvx")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve")
    ps.add_argument("--model", default="rocket6dof")
    ps.add_argument("--config", default=None)
    ps.add_argument("--K", type=int, default=None)
    ps.add_argument("--dtype", default=None)
    ps.add_argument("--out", default=None)
    ps.add_argument("--plot", default=None, metavar="PNG",
                    help="write the trajectory's figure (needs matplotlib)")
    ps.add_argument("--animate", default=None, metavar="GIF",
                    help="write an animated landing GIF (needs matplotlib)")
    ps.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one solve to DIR")

    pw = sub.add_parser("sweep")
    pw.add_argument("--model", default="rocket6dof")
    pw.add_argument("--config", default=None)
    pw.add_argument("--batch", type=int, default=256)
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--compact", nargs="?", const="device", default="off",
                    choices=["off", "device", "host"],
                    help="repack unconverged lanes so finished lanes stop "
                         "costing compute: 'device' = on-device "
                         "argsort-gather, 'host' = host repacking")
    pw.add_argument("--seeded", action="store_true",
                    help="nominal-seeded dispersion sweep: solve the "
                         "undispersed scenario once, STM-warm-start every "
                         "lane from it")
    pw.add_argument("--checkpoint", default=None)
    pw.add_argument("--metrics", default=None)
    pw.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one sweep to DIR")
    pw.add_argument("--distributed", action="store_true",
                    help="multi-process sweep: join the torch.distributed "
                         "group, sweep this rank's lanes, commit sharded "
                         "checkpoints and resume from them (needs "
                         "--coordinator, --num-processes, --process-id)")
    pw.add_argument("--coordinator", default="localhost:12345",
                    metavar="HOST:PORT", help="where rank 0 listens")
    pw.add_argument("--num-processes", type=int, default=1)
    pw.add_argument("--process-id", type=int, default=0)
    pw.add_argument("--ckpt-every", type=int, default=10,
                    help="commit cadence in SCvx iterations (distributed, "
                         "with --checkpoint)")
    pw.add_argument("--no-resume", action="store_true",
                    help="ignore an existing checkpoint instead of resuming")
    for q in (ps, pw):
        q.add_argument("--device", default="cuda",
                       help="torch device (default: the card; 'cpu' runs "
                            "the kernels' plain versions)")

    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"scvx: {e}") from None
    {"solve": cmd_solve, "sweep": cmd_sweep}[args.cmd](args, overrides, device)


if __name__ == "__main__":
    main()
