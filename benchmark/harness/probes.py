"""Counters and spans the benchmark puts around the program's public calls.

The program has no spans of its own, so in a traced run the benchmark
wraps module attributes from the outside (the pattern of ``chip_smoke.py``'s
``Capture`` and ``counted`` at commit 0394759):

- ``batch.scvx_iteration``, which every sweep driver calls once a lockstep
  iteration: counts the iterations and those that take the cold branch
  (``assume_warm_valid=False``), and starts and stops the profiler over a
  fixed span of them;
- the kernel wrappers (``cuda_fused.fused_factor``, ``cuda_kkt.tridiag_solve``,
  ``cuda_kkt.cho_solve_vec``, ``cuda_disc.discretize_lanes``): a
  ``record_function`` range ``bench.kernel.<name>`` around each call, so the
  device work the call launched is attributed to it whatever implements it,
  and the call's bound from ``work.py`` while the profiler runs;
- the layers of an SCvx iteration (``scvx.discretize``,
  ``socp.assemble``, ``ipm.ipm_solve``, ``scvx.merit_components``): a range
  ``bench.<layer>`` each, which names what the host was doing in an idle
  gap of the device.

Every wrapper calls the original; a kernel wrapper's launch counter stays
the original's (the original increments it through its module-level name,
which is the wrapper while it is installed).
"""

from __future__ import annotations

import contextlib
import time

import torch

KERNELS = {"fused_factor": "cuda_fused", "tridiag_solve": "cuda_kkt",
           "cho_solve_vec": "cuda_kkt", "discretize_lanes": "cuda_disc"}
LAYERS = {"discretize": "scvx", "assemble": "socp", "ipm_solve": "ipm",
          "merit_components": "scvx"}


class KernelProbe:
    """A kernel wrapper inside a named range; records each call's bound
    while ``recording``."""

    def __init__(self, module, name: str, bound, calls: list):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.bound, self.calls = bound, calls
        self.recording = False

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, value):
        self.orig.launches = value

    def __call__(self, *args):
        if self.recording:
            esize = next(a for a in args if torch.is_tensor(a)).element_size()
            self.calls.append((self.name, self.bound(self.name, args, esize)))
        with torch.profiler.record_function(f"bench.kernel.{self.name}"):
            return self.orig(*args)


class LayerProbe:
    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)

    def __call__(self, *args, **kwargs):
        with torch.profiler.record_function(f"bench.{self.name}"):
            return self.orig(*args, **kwargs)


class Span:
    """The profiled span: lockstep iterations [first, last) of the first
    batch, with CPU and CUDA activity."""

    def __init__(self, first: int, last: int, sync):
        self.first, self.last, self.sync = first, last, sync
        self.prof = None
        self.wall_s = None
        self.iterations = 0
        self.done = False
        self._range = None
        self._t0 = None

    def before(self, index: int, kernels: dict):
        if self.done or index != self.first:
            return
        self.sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._range = torch.profiler.record_function("bench.span")
        self._range.__enter__()
        self.launch0 = {k: p.launches for k, p in kernels.items()}
        for p in kernels.values():
            p.recording = True
        self._t0 = time.perf_counter()

    def after(self, index: int, kernels: dict):
        if self.prof is None or self.done or index != self.last - 1:
            return
        self.sync()
        self.wall_s = time.perf_counter() - self._t0
        for p in kernels.values():
            p.recording = False
        self.launches = {k: p.launches - self.launch0[k]
                         for k, p in kernels.items()}
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.iterations = self.last - self.first
        self.done = True


class Probes:
    """Install the counters (always) and, with ``span``, the ranges and the
    profiler; ``counts`` holds the lockstep and cold-branch iterations,
    ``calls`` the traced kernel calls' (name, bound seconds)."""

    def __init__(self, modules: dict, bound, span: Span | None):
        self.modules, self.span = modules, span
        self.counts = {"lockstep": 0, "cold": 0}
        self.batch_iterations = 0
        self.calls: list = []
        self.kernels: dict = {}
        self._stack = contextlib.ExitStack()
        self._bound = bound

    def new_batch(self):
        self.batch_iterations = 0

    def _set(self, module, name, value):
        orig = getattr(module, name)
        setattr(module, name, value)
        self._stack.callback(setattr, module, name, orig)

    def __enter__(self):
        batch_mod = self.modules["batch"]
        orig_iter = batch_mod.scvx_iteration
        if self.span is not None:
            for name, mod in KERNELS.items():
                probe = KernelProbe(self.modules[mod], name, self._bound,
                                    self.calls)
                self.kernels[name] = probe
                self._set(self.modules[mod], name, probe)
            for name, mod in LAYERS.items():
                self._set(self.modules[mod], name,
                          LayerProbe(self.modules[mod], name))

        def iteration(model, params, cfg, st, assume_warm_valid=False):
            index = self.batch_iterations
            self.counts["lockstep"] += 1
            self.counts["cold"] += 0 if assume_warm_valid else 1
            self.batch_iterations += 1
            if self.span is not None:
                self.span.before(index, self.kernels)
                with torch.profiler.record_function("bench.scvx_iteration"):
                    out = orig_iter(model, params, cfg, st,
                                    assume_warm_valid=assume_warm_valid)
                self.span.after(index, self.kernels)
                return out
            return orig_iter(model, params, cfg, st,
                             assume_warm_valid=assume_warm_valid)

        self._set(batch_mod, "scvx_iteration", iteration)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        if self.span is not None and self.span.prof is not None \
                and not self.span.done:
            self.span.prof.stop()      # a batch that ended inside the span
            self.span.prof = None
