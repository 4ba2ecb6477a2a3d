#!/usr/bin/env python3
"""Does the JAX package's f32 cold sweep stop above the optimum on the lanes
where the port's does?

    JAX_PLATFORMS=cpu python3 scripts/cold_stop_jax.py [--batch 16] [--seed 0]

On the CPU, without editing the JAX package: ``--batch`` dispersions of
the rocket's default scenario, made with numpy from ``--seed`` with the
main path's stds (r 0.2, v 0.1, wet mass 3%), go to both packages. Each
runs the main path's cold sweep (``solve_batch_compact_device``, K=50, 8
substeps, float32, bench.py's settings: IPM cap 15, one refinement step,
warm start, scan, Ruiz on cold solves, SCvx cap 120, chunk 10) and an f64
solve of the same lanes with the card-vs-CPU settings of ``chip_smoke.py``
(Ruiz on every solve, the default IPM cap), which stands for the optimum.
The JAX package runs its XLA algebra (``use_pallas=False``, as bench.py
does off the TPU), the port its kernels' plain versions. Prints, lane by
lane, each package's f32 sigma and iterations beside its f64 sigma, and
which lanes end ``--above`` or more over their f64 sigma in each package.
About 20-30 minutes with 4 threads.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def dispersions(seed: int, batch: int) -> dict:
    """The JAX package's default scenario, ``batch`` dispersed lanes, as
    float64 numpy arrays (the main path's stds)."""
    import jax.numpy as jnp
    import numpy as np

    from successiveconvexification_tpu.models import rocket6dof as jrk

    base = jrk.default_params(jnp.float64)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (batch,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    rng = np.random.default_rng(seed)
    d["r_init"] = d["r_init"] + 0.2 * rng.standard_normal((batch, 3))
    d["v_init"] = d["v_init"] + 0.1 * rng.standard_normal((batch, 3))
    d["m_wet"] = d["m_wet"] * (1.0 + 0.03 * rng.standard_normal(batch))
    return d


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--above", type=float, default=5e-2,
                    help="f32 sigma this far over the lane's f64 sigma "
                         "counts as a stop above the optimum")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(args.threads)
    import successiveconvexification_tpu as J
    from successiveconvexification_tpu.models import rocket6dof as jrk
    from successiveconvexification_tpu.parallel import batch as jbatch

    import chip_smoke as cs
    from successiveconvexification_tpu_torch.models import rocket6dof as trk

    P = cs._import_port()[0]
    d = dispersions(args.seed, args.batch)
    runs = {}
    for dtype, bench in (("float32", True), ("float64", False)):
        cfg = cs._configs(P, dtype, cs.MAIN_K, cs.MAIN_SUBSTEPS, bench=bench)
        jcfg = J.SolverConfig.from_dict(cfg.to_dict())
        jcfg = jcfg.replace(ipm=dataclasses.replace(jcfg.ipm, use_pallas=False))
        jpb = jrk.Rocket6DoFParams(**{k: jnp.asarray(v, dtype=dtype)
                                      for k, v in d.items()})
        t0 = time.perf_counter()
        st = jbatch.solve_batch_compact_device(J.rocket6dof_model(), jpb, jcfg,
                                               chunk=10, min_bucket=8)
        jax.block_until_ready(st.sigma)
        runs["jax", dtype] = st
        print(f"JAX {dtype}: {time.perf_counter() - t0:.1f} s (compiles "
              "included)", flush=True)
        t0 = time.perf_counter()
        runs["port", dtype] = P.solve_batch_compact_device(
            P.rocket6dof_model(),
            trk.params_from_numpy(d, dtype=getattr(torch, dtype)), cfg,
            chunk=10, min_bucket=8, device="cpu")
        print(f"port {dtype}: {time.perf_counter() - t0:.1f} s", flush=True)

    def col(who, dtype, field):
        return np.asarray(getattr(runs[who, dtype], field), dtype=np.float64)

    print(f"lane | JAX f32 sigma (iterations, converged) | JAX f64 sigma | "
          f"port f32 sigma (iterations, converged) | port f64 sigma | "
          f"f32 - f64: JAX, port")
    above = {}
    for who in ("jax", "port"):
        gap = col(who, "float32", "sigma") - col(who, "float64", "sigma")
        above[who] = set(np.flatnonzero(
            (gap >= args.above) & col(who, "float32", "converged").astype(bool)
        ).tolist())
        runs[who, "gap"] = gap
    for i in range(args.batch):
        cells = []
        for who in ("jax", "port"):
            cells.append(
                f"{col(who, 'float32', 'sigma')[i]:.6f} "
                f"({int(col(who, 'float32', 'iterations')[i])}, "
                f"{bool(col(who, 'float32', 'converged')[i])}) | "
                f"{col(who, 'float64', 'sigma')[i]:.6f}")
        print(f"{i} | {cells[0]} | {cells[1]} | "
              f"{runs['jax', 'gap'][i]:+.4e}, {runs['port', 'gap'][i]:+.4e}")
    for who in ("jax", "port"):
        conv64 = int(col(who, "float64", "converged").sum())
        print(f"{who}: f32 converged {int(col(who, 'float32', 'converged').sum())}"
              f"/{args.batch}, f64 converged {conv64}/{args.batch}; f32 lanes "
              f"{args.above:g} or more above the f64 sigma: "
              f"{sorted(above[who])}")
    print(f"f64 sigma, JAX against the port: max abs diff "
          f"{np.abs(col('jax', 'float64', 'sigma') - col('port', 'float64', 'sigma')).max():.3e}; "
          f"lanes above in both: {sorted(above['jax'] & above['port'])}, "
          f"in the port only: {sorted(above['port'] - above['jax'])}, "
          f"in JAX only: {sorted(above['jax'] - above['port'])}")


if __name__ == "__main__":
    main()
