"""kkt_roofline_share (%): the summed bound over the summed device time of
the profiled calls of ``fused_factor``, ``tridiag_solve`` and
``cho_solve_vec``. A call's bound is the larger of its bytes over 3.35 TB/s
and its operations over 67 TFLOP/s (``harness/work.py``); its device time
is that of the device work launched inside the benchmark's range around
the call."""

KERNELS = ("fused_factor", "tridiag_solve", "cho_solve_vec")


def read(run):
    t = run["trace"]
    if not t:
        return None
    dev = sum(t["kernel_device_s"].get(k, 0.0) for k in KERNELS)
    bound = sum(t["kernel_bound_s"].get(k, 0.0) for k in KERNELS)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
