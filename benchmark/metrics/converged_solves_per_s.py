"""converged_solves_per_s (solves/s): lanes the program reports converged
within its feasibility floor, over every batch of the window, divided by
the whole window."""


def read(run):
    if run["window_s"] <= 0:
        return None
    return sum(b["converged"] for b in run["batches"]) / run["window_s"]
