"""One run of one cell: set-up, warm-up, the measured window, the check,
the metrics, and the result line.

``Session`` holds a cell's set-up (kernels, the nominal, the warm-up);
``Session.measure`` runs one window on it and judges it. ``run_cell`` is a
run of ``run.py``: one session, one window. ``readings.py`` measures many
seeds on one session, with the control. Both take the device and, for
tests at a small size on the CPU, overrides of the configuration and the
mix.
"""

from __future__ import annotations

import copy
import gc
import os
import sys
import time
from pathlib import Path

import torch

from harness import cells, check, probes, tracing, traffic, window, work
from harness.program import Program

FORBIDDEN = ("jax", "jaxlib", "flax", "successiveconvexification_tpu")
GPUS = Path("/proc/driver/nvidia/gpus")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``successiveconvexification_tpu_torch`` is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_ordinal(dev) -> int:
    """The card's place among the host's cards by PCI address (the
    driver's list under /proc, which every process sees whatever cards it
    is given), or the device's index where that list is not readable."""
    p = torch.cuda.get_device_properties(dev)
    mine = f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}"
    try:
        cards = sorted(d.name.lower() for d in GPUS.iterdir())
    except OSError:
        cards = []
    for i, name in enumerate(cards):
        if name.startswith(mine):
            return i
    return dev.index or 0


def steady_host(dev) -> int:
    """Keep the host's side of the run on one CPU with one intra-op thread,
    and return that CPU: the program's time is host dispatch, and a thread
    that moves between CPUs of a shared host reads the neighbours' load.
    The CPU is the card's own (the card's ordinal counted down from the
    last CPU of the process's set), so runs on different cards of one host
    never share it. Called once the kernels are built, so a first run's
    build keeps every CPU."""
    cpus = sorted(os.sched_getaffinity(0))
    cpu = cpus[-1 - card_ordinal(dev) % len(cpus)]
    os.sched_setaffinity(0, {cpu})
    torch.set_num_threads(1)
    return cpu


def _merge(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


class Session:
    """A cell set up: the program built and loaded, the nominal solved
    where the mix has one, one lockstep iteration of each branch warmed up
    at the batch's width. ``program_hook(program)`` may replace parts of
    the program (the tests' planted faults)."""

    def __init__(self, benchmark: dict, workload: str, device="cuda",
                 t_start: float | None = None, config_over: dict | None = None,
                 mix_over: dict | None = None, program_hook=None):
        t_start = time.perf_counter() if t_start is None else t_start
        self.cell = cells.cell(benchmark, workload)
        w = self.cell["workload"]
        self.chips = w["chips"]
        self.config = _merge(cells.config(w["config"]), config_over)
        self.mix = _merge(cells.traffic(w["traffic"]), mix_over)
        self.dev = dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        parts = {"start": time.perf_counter() - t_start}
        self.prog = Program(self.config, self.mix, dev)
        if program_hook is not None:
            program_hook(self.prog)
        self.prog.build()
        self.host_cpu = steady_host(dev) if dev.type == "cuda" else None
        parts["kernels"] = time.perf_counter() - t_start
        self.nominal = None
        if self.mix["nominal"]:
            fields = traffic.nominal(self.config, dev)
            st = self.prog.solve_nominal(fields)
            self.prog.sync()
            self.nominal = (fields, st.X, st.U, st.sigma)
            parts["nominal"] = time.perf_counter() - t_start
        self.prog.warm_up(traffic.batch(self.config, self.mix, 0, -1, dev))
        self.prog.sync()
        self.setup_s = time.perf_counter() - t_start
        parts["warm_up"] = self.setup_s
        self.setup_parts = parts

    def measure(self, seed: int, seconds: float, trace: bool,
                control: bool = False, keep: bool = True) -> dict:
        """One window and its check: the contract's last line, as a dict,
        with ``setup_parts``, ``batches`` and ``check_s`` (the reference's
        seconds) besides; ``control`` adds the control's numbers to
        ``checks``. Without ``keep`` the program's state is freed before
        the check (the last window of a process)."""
        config, mix, dev, prog = self.config, self.mix, self.dev, self.prog
        span = None
        if trace:
            first, last = mix["trace_iterations"]
            span = probes.Span(first, last, prog.sync)
        answers, batches = [], []
        with probes.Probes(prog.modules, work.bound_s, span) as pr:
            def run_batch(i):
                fields = traffic.batch(config, mix, seed, i, dev)
                pr.new_batch()
                cold0 = pr.counts["cold"]
                st = prog.solve(fields)
                prog.sync()
                rec = {"lanes": int(st.converged.numel()),
                       "converged": int(prog.floor_met(st).sum()),
                       "lockstep": int(st.iterations.max()),
                       "cold": pr.counts["cold"] - cold0}
                answers.append((fields, st.X, st.U, st.sigma))
                return rec

            done = window.run_window(run_batch, seconds)
        for wall, rec in done:
            rec["wall_s"] = wall
            batches.append(rec)
        counts = dict(pr.counts)

        trace_data = None
        if span is not None and span.done:
            trace_data = tracing.reduce(span.prof, span.wall_s,
                                        span.iterations, pr.calls,
                                        span.launches)
            span.prof = None
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)

        # ---- the check, once the program's state is freed
        nominal = self.nominal
        if not keep:
            self.prog = self.nominal = prog = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers, ctrl, check_s = check.judge_run(config, answers, nominal,
                                                 seed, control)
        correct, checks = check.verdict(config, numbers)
        if ctrl is not None:
            for name, value in ctrl.items():
                checks[f"control.{name}"] = {"value": value,
                                             "limit": checks[name]["limit"]}

        run = {"setup_s": self.setup_s,
               "window_s": sum(b["wall_s"] for b in batches),
               "batches": batches, "counts": counts, "trace": trace_data}
        metrics = {}
        for m in (self.cell["per_layer"] if trace else self.cell["end_to_end"]):
            value = cells.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        lanes = sum(b["lanes"] for b in batches)
        dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                    "kind": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                    "count": self.chips, "memory_peak_bytes": memory_peak}
        result = {"correct": correct, "attempted": lanes,
                  "failed": lanes - sum(b["converged"] for b in batches),
                  "metrics": metrics, "device": dev_info,
                  "host_cpu": self.host_cpu}
        if trace:
            td = trace_data or {}
            dev_info["busy_s"] = td.get("busy_s", 0.0)
            dev_info["window_s"] = td.get("span_wall_s", 0.0)
            if td:
                result["breakdown"] = {"device_ops": td["device_ops"],
                                       "idle_gaps": td["idle_gaps"]}
        result["setup_parts"] = self.setup_parts
        result["batches"] = batches
        result["check_s"] = check_s
        result["checks"] = checks
        return result


def run_cell(benchmark: dict, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float | None = None,
             config_over: dict | None = None, mix_over: dict | None = None,
             program_hook=None) -> dict:
    """One run: a session and one window on it (see ``Session.measure``)."""
    s = Session(benchmark, workload, device, t_start, config_over, mix_over,
                program_hook)
    return s.measure(seed, seconds, trace, keep=False)
