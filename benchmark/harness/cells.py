"""Find a cell, its configuration, its traffic mix and its metric readers
by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own:

    benchmark/configs/<config>.json     sizes, solver settings, scenario
    benchmark/reference/<model>.py      the configuration's plain reference
    benchmark/traffic/<traffic>.json    the mix the one generator reads
    benchmark/metrics/<metric>.py       ``read(run) -> number or None``

so a later cell, configuration, mix or metric is added by adding files and
entries, and no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return _load_json(root / "BENCHMARK.json")


def config(name: str, bench: Path = BENCH) -> dict:
    return _load_json(bench / "configs" / f"{check_name(name)}.json")


def traffic(name: str, bench: Path = BENCH) -> dict:
    return _load_json(bench / "traffic" / f"{check_name(name)}.json")


def reader(name: str, bench: Path = BENCH):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench / "metrics" / f"{check_name(name)}.py"
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def cell(benchmark: dict, workload: str) -> dict:
    """The cell named ``workload`` with its metrics: the end-to-end ones it
    reports (``trace`` 0) and the per-layer ones (``trace`` 1)."""
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "workload": w,
        "end_to_end": [m for m in benchmark["end_to_end"] if applies(m)],
        "per_layer": [m for m in benchmark["per_layer"] if applies(m)],
    }
