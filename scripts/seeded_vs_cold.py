#!/usr/bin/env python3
"""Lane by lane: the seeded sweep's sigma against the cold sweep's.

    python3 scripts/seeded_vs_cold.py [--device cuda] [--batch 256] [--worst 4]

Runs the main path of ``chip_smoke.py`` (the 6-DoF rocket, K=50, 8 substeps,
f32, bench.py's settings, the dispersions from a torch.Generator seeded
with 0) cold with ``solve_batch_compact_device`` and seeded from the
nominal with ``solve_batch_seeded``, and prints the distribution of the
seeded minus the cold sigma over the lanes converged on both, the lanes
furthest apart (iterations, penalty bumps, defect plus violation, final
mass), and then the ``--worst`` of those lanes solved again in f64 with
the card-vs-CPU settings (Ruiz on every solve), cold and seeded, to show
which f32 run stopped away from the optimum. About 4 minutes on an H100.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=cs.MAIN_B)
    ap.add_argument("--worst", type=int, default=4)
    args = ap.parse_args()

    import torch

    P, _build, *_ = cs._import_port()
    from successiveconvexification_tpu_torch.models import rocket6dof as rk
    from successiveconvexification_tpu_torch.ops.precision import resolve_device

    dev = str(resolve_device(args.device))
    if dev.startswith("cuda"):
        print(cs._card_line())
        _build.build_all()
    model = P.rocket6dof_model()

    def both_ways(pb, cfg):
        cold = P.solve_batch_compact_device(model, pb, cfg, chunk=10,
                                            min_bucket=32, device=dev)
        nom = P.scvx_solve(model, rk.default_params(pb.dtype, dev), cfg,
                           device=dev)
        seeded = P.solve_batch_seeded(
            model, pb, cfg, nominal_solution=(nom.X[0], nom.U[0], nom.sigma[0]),
            chunk=10, min_bucket=32, device=dev)
        return cold, seeded, nom

    cfg = cs._configs(P, "float32", cs.MAIN_K, cs.MAIN_SUBSTEPS, bench=True)
    pb = cs._dispersed(P, args.batch, torch.float32, dev)
    cold, seeded, nom = both_ways(pb, cfg)
    both = cold.converged & seeded.converged
    d = (seeded.sigma - cold.sigma).double()
    q = [0.0, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0]
    qv = torch.quantile(d[both], torch.tensor(q, dtype=torch.float64,
                                              device=d.device)).tolist()
    print(f"f32 B={args.batch}: nominal sigma {float(nom.sigma[0]):.6f} in "
          f"{int(nom.iterations[0])} iterations; converged cold "
          f"{int(cold.converged.sum())}, seeded {int(seeded.converged.sum())}; "
          f"seeded - cold sigma over {int(both.sum())} lanes converged on "
          f"both: quantiles {dict(zip(q, [round(v, 6) for v in qv]))}; lower "
          f"by more than 5e-2: {int(((d < -5e-2) & both).sum())}, higher: "
          f"{int(((d > 5e-2) & both).sum())}; mean sigma cold "
          f"{float(cold.sigma.mean()):.5f}, seeded {float(seeded.sigma.mean()):.5f}")
    order = torch.argsort(torch.where(both, d.abs(), -1.0), descending=True)
    for i in order[:8].tolist():
        row = []
        for name, st in (("cold", cold), ("seeded", seeded)):
            row.append(f"{name} sigma {float(st.sigma[i]):.5f} iterations "
                       f"{int(st.iterations[i])} bumps {int(st.n_bump[i])} "
                       f"defect+violation "
                       f"{float(st.defect_nl[i] + st.viol_nl[i]):.2e} final "
                       f"mass {float(st.X[i, -1, 0]):.5f}")
        print(f"lane {i}: " + " | ".join(row))
    idx = order[:args.worst]
    cfg64 = cs._configs(P, "float64", cs.MAIN_K, cs.MAIN_SUBSTEPS, bench=False)
    cold64, seeded64, _ = both_ways(
        pb.index(idx).map(lambda v, tail: v.double()), cfg64)
    for name, st32, st64 in (("cold", cold, cold64), ("seeded", seeded, seeded64)):
        print(f"lanes {idx.tolist()} {name}: f32 sigma "
              f"{[round(v, 5) for v in st32.sigma[idx].tolist()]}, f64 sigma "
              f"{[round(v, 6) for v in st64.sigma.tolist()]}, f64 iterations "
              f"{st64.iterations.tolist()}, converged {st64.converged.tolist()}")


if __name__ == "__main__":
    main()
