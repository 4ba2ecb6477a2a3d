"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names are compared whole, so the port's own name passes."""

import subprocess
import sys

from harness import runner

PROBE = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import importlib, pathlib
import torch
import run, readings
from harness import cells, check, probes, program, runner, tracing, traffic, window, work
from reference import conic, judge, rocket6dof, pointmass3dof, scvx
import successiveconvexification_tpu_torch
from successiveconvexification_tpu_torch.parallel import batch
from successiveconvexification_tpu_torch.ops import _build, cuda_disc, cuda_fused, cuda_kkt, ipm, scvx, socp
for p in sorted(pathlib.Path({bench!r}, "metrics").glob("*.py")):
    cells.reader(p.stem)
print("forbidden:" + ",".join(runner.forbidden_modules()))
"""


def test_nothing_loads_jax():
    bench = str(runner.cells.BENCH)
    root = str(runner.cells.BENCH.parent)
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(bench=bench, root=root)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "successiveconvexification_tpu_torch",
                        sys.modules.get("successiveconvexification_tpu_torch",
                                        object()))
    assert "successiveconvexification_tpu_torch" not in \
        runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "successiveconvexification_tpu.ops",
                        object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert runner.forbidden_modules() == ["jaxlib",
                                          "successiveconvexification_tpu"]
