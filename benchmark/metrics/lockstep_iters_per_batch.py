"""lockstep_iters_per_batch (iters): the mean over the window's batches of
the largest ``ScvxState.iterations`` of a batch's lanes."""


def read(run):
    b = run["batches"]
    return sum(x["lockstep"] for x in b) / len(b) if b else None
