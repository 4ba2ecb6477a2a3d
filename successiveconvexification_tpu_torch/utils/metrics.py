"""Metrics, logging and profiling (PyTorch port).

The counterpart of the JAX package's ``utils/metrics.py``: a JSONL writer
with a run manifest, a ``torch.profiler`` trace, the flops and bytes of a
function, and its speed-of-light fraction against the card's peaks.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


class JsonlLogger:
    """Append-only JSONL metrics writer with a run manifest."""

    def __init__(self, path: str, manifest: Optional[Dict[str, Any]] = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        if manifest is not None:
            self.log({"_manifest": manifest, "_t": time.time()})

    def log(self, record: Dict[str, Any]) -> None:
        def conv(v):
            if isinstance(v, torch.Tensor):
                return v.detach().cpu().tolist()
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, (np.floating, np.integer)):
                return v.item()
            return v

        self._f.write(json.dumps({k: conv(v) for k, v in record.items()}) + "\n")

    def close(self):
        self._f.close()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA when a card is
    present) and write a Chrome trace, ``logdir``/trace.json (Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class _BytesMode(TorchDispatchMode):
    """Sums, over the operators a call runs, the bytes of each operator's
    tensor inputs and outputs (views move nothing and are skipped)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            flat = list(args) + list((kwargs or {}).values())
            flat += list(out) if isinstance(out, (tuple, list)) else [out]
            self.bytes += sum(t.numel() * t.element_size() for t in flat
                              if isinstance(t, torch.Tensor))
        return out


def cost_analysis(fn, *args, **kwargs) -> Dict[str, float]:
    """The flops and bytes of one call of ``fn`` on these arguments:
    ``flops`` by ``torch.utils.flop_counter`` (matrix products,
    convolutions, attention), ``bytes_accessed`` each operator's inputs
    read once and outputs written once. On ``x @ x`` at 64 x 64 float32
    both equal XLA's ``cost_analysis`` in the JAX package (524,288 and
    49,152)."""
    with FlopCounterMode(display=False) as flops, _BytesMode() as nbytes:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(nbytes.bytes)}


def sol_fraction(flops: float, seconds: float, peak_flops: float) -> float:
    """Speed-of-light fraction for a measured kernel or step."""
    if seconds <= 0 or peak_flops <= 0:
        return 0.0
    return (flops / seconds) / peak_flops


# published peaks (NVIDIA's data sheet, SXM part, dense rates, full power)
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3, 700 W": {
        "hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12, "f64_flops": 34e12},
}
