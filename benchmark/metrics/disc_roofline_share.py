"""disc_roofline_share (%): as ``kkt_roofline_share``, for the calls of
``discretize_lanes`` (either model's instantiation)."""


def read(run):
    t = run["trace"]
    if not t:
        return None
    dev = t["kernel_device_s"].get("discretize_lanes", 0.0)
    bound = t["kernel_bound_s"].get("discretize_lanes", 0.0)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
