"""cold_branch_share (%): lockstep iterations that took the cold-init
branch (``assume_warm_valid=False``) over all lockstep iterations of the
window, counted by the benchmark's wrapper of ``batch.scvx_iteration``."""


def read(run):
    c = run["counts"]
    return 100.0 * c["cold"] / c["lockstep"] if c["lockstep"] else None
