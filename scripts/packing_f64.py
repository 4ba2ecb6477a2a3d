#!/usr/bin/env python3
"""How far does a lane's f64 solve at K=50 move with the batch's packing,
in each package?

    JAX_PLATFORMS=cpu python3 scripts/packing_f64.py --lanes 5,7 \
        [--batch 16] [--seed 0] [--threads 4]

On the CPU, without editing the JAX package: ``--batch`` dispersions of the
rocket's default scenario, made with numpy from ``--seed`` as
``scripts/cold_stop_jax.py`` makes them, go to both packages at the f64
card-vs-CPU settings of ``chip_smoke.py`` (K=50, 8 substeps, Ruiz on every
solve, the default IPM cap, SCvx cap 120). Each package solves every lane
of ``--lanes`` alone (``solve_batch``, B=1) and the whole batch packed
(``solve_batch_compact_device``, chunk 10, min bucket 8). The JAX package
runs its XLA algebra (``use_pallas=False``), the port its kernels' plain
versions. Prints, lane by lane, each package's sigma and SCvx iterations
in both packings, the packages' differences and each package's own
difference between its two packings. About 15 minutes with 4 threads,
most of it the JAX package's compiles.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", default="5,7",
                    help="comma-separated lanes also solved alone")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    lanes = [int(x) for x in args.lanes.split(",")]

    import dataclasses

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
    from cold_stop_jax import dispersions
    from successiveconvexification_tpu_torch.models import rocket6dof as trk

    P = cs._import_port()[0]
    d = dispersions(args.seed, args.batch)
    cfg = cs._configs(P, "float64", cs.MAIN_K, cs.MAIN_SUBSTEPS, bench=False)
    jcfg = J.SolverConfig.from_dict(cfg.to_dict())
    jcfg = jcfg.replace(ipm=dataclasses.replace(jcfg.ipm, use_pallas=False))
    jmodel, tmodel = J.rocket6dof_model(), P.rocket6dof_model()

    def jax_params(sel):
        return jrk.Rocket6DoFParams(**{k: jnp.asarray(v[sel])
                                       for k, v in d.items()})

    def port_params(sel):
        return trk.params_from_numpy({k: v[sel] for k, v in d.items()},
                                     dtype=torch.float64)

    def read(st):
        return (np.asarray(st.sigma, dtype=np.float64),
                np.asarray(st.iterations), np.asarray(st.converged))

    runs = {}
    every = slice(None)
    for packing in ["batch"] + lanes:
        sel = every if packing == "batch" else slice(packing, packing + 1)
        t0 = time.perf_counter()
        if packing == "batch":
            st = jbatch.solve_batch_compact_device(jmodel, jax_params(sel),
                                                   jcfg, chunk=10,
                                                   min_bucket=8)
        else:
            st = jbatch.solve_batch(jmodel, jax_params(sel), jcfg)
        jax.block_until_ready(st.sigma)
        runs["jax", packing] = read(st)
        t1 = time.perf_counter()
        if packing == "batch":
            st = P.solve_batch_compact_device(tmodel, port_params(sel), cfg,
                                              chunk=10, min_bucket=8,
                                              device="cpu")
        else:
            st = P.solve_batch(tmodel, port_params(sel), cfg, device="cpu")
        runs["port", packing] = read(st)
        print(f"packing {packing}: JAX {t1 - t0:.1f} s (compiles included), "
              f"port {time.perf_counter() - t1:.1f} s", flush=True)

    print(f"B={args.batch}, solve_batch_compact_device(chunk=10, "
          "min_bucket=8): lane | sigma (iterations, converged) JAX | port | "
          "JAX - port")
    sj, ij, cj = runs["jax", "batch"]
    sp, ip, cp = runs["port", "batch"]
    for i in range(args.batch):
        print(f"  {i} | {sj[i]:.10f} ({ij[i]}, {bool(cj[i])}) | {sp[i]:.10f} "
              f"({ip[i]}, {bool(cp[i])}) | {sj[i] - sp[i]:+.3e}")
    diff = np.abs(sj - sp)
    print(f"  max |JAX - port| {diff.max():.3e}; lanes 1e-4 or more apart "
          f"{np.flatnonzero(diff >= 1e-4).tolist()}; largest iteration gap "
          f"{int(np.abs(ij.astype(int) - ip.astype(int)).max())}")
    print("each lane alone (solve_batch, B=1): lane | JAX | port | JAX - "
          "port | JAX B=1 - B=batch | port B=1 - B=batch")
    for i in lanes:
        (s1j, i1j, _), (s1p, i1p, _) = runs["jax", i], runs["port", i]
        print(f"  {i} | {s1j[0]:.10f} ({i1j[0]}) | {s1p[0]:.10f} ({i1p[0]}) | "
              f"{s1j[0] - s1p[0]:+.3e} | {s1j[0] - sj[i]:+.3e} | "
              f"{s1p[0] - sp[i]:+.3e}")


if __name__ == "__main__":
    main()
