"""aten_calls_per_iter (calls): aten operator calls, nested ones included,
per lockstep iteration of the profiled span (``key_averages()``)."""


def read(run):
    t = run["trace"]
    if not t or not t["iterations"] or not t["aten_calls"]:
        return None
    return t["aten_calls"] / t["iterations"]
