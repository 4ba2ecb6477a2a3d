"""kkt_launches_per_iter (launches): launches of the KKT kernel wrappers
(``fused_factor``, ``tridiag_solve``, ``cho_solve_vec``) by their own
counters over the profiled span, per lockstep iteration."""

KERNELS = ("fused_factor", "tridiag_solve", "cho_solve_vec")


def read(run):
    t = run["trace"]
    if not t or not t["iterations"]:
        return None
    n = sum(t["launches"].get(k, 0) for k in KERNELS)
    return n / t["iterations"] if n else None
