#!/usr/bin/env python3
"""Where one SCvx iteration of the PyTorch port spends its time, on the card.

    python3 scripts/profile_torch_iteration.py

Main-path shapes (B=256, K=50, 8 RK4 substeps, float32, the IPM settings of
``bench.py``). After three iterations (the first is cold) it times the
stages of one ``scvx_iteration`` in the branch the batch driver would take
(all-warm only when every lane's IPM carry is valid) separately —
discretize, assemble, IPM, nonlinear merit — with a device synchronize
around each, then traces that iteration whole with ``torch.profiler`` and
prints the device-side operations (kernels,
copies, sets; not the aten operators that launched them), the device's busy
time as the union of their intervals, and the kernels with the most device
time. Needs one CUDA device.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import successiveconvexification_tpu_torch as T  # noqa: E402
from successiveconvexification_tpu_torch.models import rocket6dof as rk  # noqa: E402
from successiveconvexification_tpu_torch.ops import _build, ipm, socp  # noqa: E402
from successiveconvexification_tpu_torch.ops import scvx as S  # noqa: E402
from successiveconvexification_tpu_torch.ops.discretize import discretize  # noqa: E402


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_busy_ms(events) -> tuple[float, float]:
    """(busy, span) in ms of profiler events: the union of their
    [start, end) intervals, so overlapping events count once, and the time
    from the first start to the last end."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e3, (max(e for _, e in spans) - spans[0][0]) / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_iteration: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    B, K = 256, 50
    cfg = T.SolverConfig(
        dtype="float32", disc=T.DiscretizationConfig(K=K, substeps=8),
        ipm=T.IPMConfig(max_iters=15, refine_steps=1),
        scvx=dataclasses.replace(T.ScvxConfig(), max_iters=120))
    model = T.rocket6dof_model()
    params = rk.default_params(torch.float32, "cuda")
    pb = T.sample_dispersions(params, torch.Generator().manual_seed(0), B,
                              r_std=0.2, v_std=0.1, m_frac_std=0.03)
    st = T.scvx_init(model, pb, cfg)
    for _ in range(3):
        warm = bool(torch.isfinite(st.ipm_carry.gap).all())
        st = T.scvx_iteration(model, pb, cfg, st, assume_warm_valid=warm)
    # the branch the batch driver would take for this state: all-warm (no
    # cold init, no Ruiz) only when every lane's carry is valid; at B=256
    # some lane's carry is usually invalid, and the general branch runs
    valid = torch.isfinite(st.ipm_carry.gap)
    warm = bool(valid.all())
    branch = "all-warm" if warm else "general (cold init and Ruiz in every lane)"
    print(f"{torch.cuda.get_device_name(0)}; after 3 iterations "
          f"{int(valid.sum())}/{B} carries valid: the {branch} branch")

    # ---- stage split of one iteration (synchronized between stages) -------
    s = cfg.scvx
    disc, t_disc = _timed(lambda: discretize(model, pb, st.X, st.U, st.sigma,
                                             substeps=8))
    d, t_asm = _timed(lambda: socp.assemble(
        model, s, pb, disc, st.X, st.U, st.sigma, st.tr_radius,
        penalty_scale=st.penalty_scale))
    if warm:
        ipm_cfg = dataclasses.replace(cfg.ipm, equilibrate=False)
        sol, t_ipm = _timed(lambda: ipm.ipm_solve(d, ipm_cfg, init=st.ipm_carry))
    else:
        sol, t_ipm = _timed(lambda: ipm.ipm_solve(
            d, cfg.ipm, init=st.ipm_carry, init_valid=valid))
    _, t_merit = _timed(lambda: S.merit_components(
        model, cfg, pb, st.X, st.U, st.sigma))
    _, t_all = _timed(lambda: T.scvx_iteration(model, pb, cfg, st,
                                               assume_warm_valid=warm))
    print(f"stage ms ({branch} iteration): discretize {t_disc:.1f}, assemble "
          f"{t_asm:.1f}, IPM {t_ipm:.1f} ({int(sol.iters.max())} iterations, "
          f"{t_ipm / max(int(sol.iters.max()), 1):.1f} ms each), merit "
          f"{t_merit:.1f}; whole iteration {t_all:.1f}")

    # ---- device trace of the same iteration ---------------------------------
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        T.scvx_iteration(model, pb, cfg, st, assume_warm_valid=warm)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # only the device-side events (kernels, copies, sets): an aten operator's
    # device time is that of the kernels it launched, which are listed too
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("profile_torch_iteration: the trace holds no device events",
              file=sys.stderr)
        return 1
    busy_ms, span_ms = device_busy_ms(dev)
    print(f"traced {branch} iteration: wall {wall:.1f} ms, {len(dev)} device "
          f"operations, device busy {busy_ms:.1f} ms (union of their "
          f"intervals; {100 * busy_ms / wall:.1f}% of the wall, "
          f"{100 * busy_ms / max(span_ms, 1e-9):.1f}% of the {span_ms:.1f} ms "
          "from the first to the last)")
    per_name = {}
    for e in dev:
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                            n + 1)
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:9.2f} ms  {n:6d}x  {name[:90]}")
    # host side: the PyTorch operators the iteration dispatches
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    n_ops = sum(e.count for e in ops)
    host_ms = sum(e.self_cpu_time_total for e in ops) / 1e3
    print(f"host: {n_ops} aten operator calls (nested calls included), "
          f"{host_ms:.1f} ms self CPU time in them; the most called:")
    for e in sorted(ops, key=lambda e: -e.count)[:12]:
        print(f"  {e.count:7d}x  {e.self_cpu_time_total / 1e3:9.2f} ms  {e.key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
