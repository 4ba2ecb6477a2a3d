"""The one command on the card: every cell, once untraced and once traced,
gives a result line with every metric the cell reports and ``correct``
true (one batch each: ``--seconds 1``)."""

import json
import subprocess
import sys

import pytest

from harness import cells

ROOT = cells.BENCH.parent
SPEC = cells.spec(ROOT)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         str(2 ** 31 + 7), "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    c = cells.cell(SPEC, workload)
    want = {m["name"] for m in c["per_layer" if trace else "end_to_end"]}
    assert set(res["metrics"]) == want
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
