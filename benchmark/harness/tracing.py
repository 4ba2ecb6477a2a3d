"""Reduce the profiled span to the numbers the per-layer readers take.

``device_busy_s`` is ``scripts/profile_torch_iteration.py``'s
``device_busy_ms`` at commit 0394759 (the union of the device intervals, so
overlapping operations count once), in seconds. The profiler puts each
``record_function`` range on the device's timeline too, spanning the device
work launched inside it; those annotations are not device operations. A
kernel range's device time (``bench.kernel.<name>``) is the time of the
device operations that lie inside its annotations.
"""

from __future__ import annotations

from collections import defaultdict


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _is_annotation(e) -> bool:
    return e.name.startswith("bench.") or bool(
        getattr(e, "is_user_annotation", False))


def _inside(ops, intervals) -> float:
    """Seconds of the operations (start, end) that lie inside one of the
    disjoint ``intervals``."""
    total, j = 0.0, 0
    intervals = sorted(intervals)
    for s, e in sorted(ops):
        while j < len(intervals) and intervals[j][1] < s:
            j += 1
        if j < len(intervals) and intervals[j][0] <= s and e <= intervals[j][1]:
            total += e - s
    return total / 1e6


def device_busy_s(events) -> tuple[float, float]:
    """(busy, span) in seconds: the union of the events' [start, end)
    intervals, and the time from the first start to the last end."""
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
    return busy / 1e6, (max(e for _, e in spans) - spans[0][0]) / 1e6


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, span_wall_s: float, iterations: int, calls: list,
           launches: dict) -> dict:
    """The span's readings: device busy time, aten calls, device time and
    bound by kernel range, launches, the top device operations and the
    idle gaps by the range the host was in."""
    events = list(prof.events())
    device = [e for e in events if _is_device(e) and not _is_annotation(e)]
    notes = [e for e in events if _is_device(e) and _is_annotation(e)]
    host = [e for e in events if not _is_device(e)]
    span = next((e for e in host if e.name == "bench.span"), None)
    busy_s, _ = device_busy_s(device)

    spans = [(d.time_range.start, d.time_range.end) for d in device]
    kernel_device_s = {}
    for name in {n.name for n in notes if n.name.startswith("bench.kernel.")}:
        kernel_device_s[name[len("bench.kernel."):]] = _inside(
            spans, [(n.time_range.start, n.time_range.end) for n in notes
                    if n.name == name])

    bound_by_kernel = defaultdict(float)
    calls_by_kernel = defaultdict(int)
    for name, b in calls:
        bound_by_kernel[name] += b
        calls_by_kernel[name] += 1

    aten = sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))

    ops = defaultdict(float)
    for d in device:
        ops[d.name] += (d.time_range.end - d.time_range.start) / 1e6
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]

    gaps = []
    if span is not None:
        lo, hi = span.time_range.start, span.time_range.end
        cur = lo
        for s, e in _merged(spans):
            if e <= lo or s >= hi:
                continue
            if s > cur:
                gaps.append((cur, min(s, hi)))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
    idle = defaultdict(float)
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.name.startswith("bench.")
                     and e.name != "bench.span"), key=lambda r: (r[0], -r[1]))
    stack, i = [], 0
    for g0, g1 in gaps:                     # gaps are in time order
        while i < len(ranges) and ranges[i][0] <= g0:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        inner = [r for r in stack if r[1] >= g0]
        label = inner[-1][2] if inner else "host"
        idle[label] += (g1 - g0) / 1e6
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]

    return {
        "span_wall_s": span_wall_s,
        "iterations": iterations,
        "busy_s": busy_s,
        "aten_calls": aten,
        "kernel_device_s": kernel_device_s,
        "kernel_bound_s": dict(bound_by_kernel),
        "kernel_calls": dict(calls_by_kernel),
        "launches": dict(launches),
        "device_ops": [[n, s] for n, s in top_ops],
        "idle_gaps": [[n, s] for n, s in top_idle],
    }
