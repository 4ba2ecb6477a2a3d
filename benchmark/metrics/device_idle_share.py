"""device_idle_share (%): one minus the union of the device operations'
intervals over the profiled span's wall (synchronized at both ends)."""


def read(run):
    t = run["trace"]
    if not t or not t["span_wall_s"] or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_wall_s"])
