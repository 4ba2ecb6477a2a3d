"""lockstep_iter_ms (ms): the whole window over all lockstep SCvx
iterations in it; a batch runs as many as its lanes' largest iteration
count."""


def read(run):
    n = sum(b["lockstep"] for b in run["batches"])
    return 1e3 * run["window_s"] / n if n else None
