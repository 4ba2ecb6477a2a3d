"""Cells, configurations, mixes and metrics are found by name, as files of
their own; names and units keep to the allowed characters; BENCHMARK.json
has the contract's shape."""

import json
import re
import shutil

import pytest

from harness import cells

ROOT = cells.BENCH.parent
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_unit(unit):
    if not UNIT.match(unit):
        raise ValueError(f"not a valid unit: {unit!r}")
    return unit


def _spec():
    return cells.spec(ROOT)


def test_new_cell_needs_only_new_files(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "pointmass3dof_k30.json").read_text())
    cfg["name"] = "pointmass3dof_k40"
    cfg["solver"]["disc"]["K"] = 40
    (bench / "configs" / "pointmass3dof_k40.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "cold_b16384.json").read_text())
    mix["name"], mix["batch"] = "cold_b1024", 1024
    (bench / "traffic" / "cold_b1024.json").write_text(json.dumps(mix))
    (bench / "metrics" / "lanes_per_batch.py").write_text(
        "def read(run):\n"
        "    b = run['batches']\n"
        "    return sum(x['lanes'] for x in b) / len(b) if b else None\n")
    spec = _spec()
    spec["workloads"].append({"name": "pointmass3dof_k40.cold_b1024",
                              "config": "pointmass3dof_k40",
                              "traffic": "cold_b1024", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "lanes_per_batch", "unit": "lanes",
                              "better": "higher", "source": "program_counter",
                              "layer": "sweep driver (parallel/batch.py)",
                              "moves": "converged_solves_per_s",
                              "workloads": ["pointmass3dof_k40.cold_b1024"]})
    c = cells.cell(spec, "pointmass3dof_k40.cold_b1024")
    w = c["workload"]
    assert cells.config(w["config"], bench)["solver"]["disc"]["K"] == 40
    assert cells.traffic(w["traffic"], bench)["batch"] == 1024
    names = [m["name"] for m in c["per_layer"]]
    assert "lanes_per_batch" in names
    read = cells.reader("lanes_per_batch", bench)
    assert read({"batches": [{"lanes": 1024}, {"lanes": 1024}]}) == 1024
    # the metric that names its cells is not reported elsewhere
    assert "lanes_per_batch" not in [
        m["name"] for m in cells.cell(spec, "pointmass3dof_k30.cold_b16384")
        ["per_layer"]]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_every_name_and_file_resolves():
    spec = _spec()
    for w in spec["workloads"]:
        c = cells.cell(spec, w["name"])
        cfg = cells.config(w["config"])
        assert cfg["name"] == w["config"]
        assert cells.traffic(w["traffic"])["name"] == w["traffic"]
        assert (cells.BENCH / "reference" / f"{cfg['model']}.py").exists()
        for m in c["end_to_end"] + c["per_layer"]:
            assert callable(cells.reader(m["name"]))
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


@pytest.mark.parametrize("name,ok", [
    ("rocket6dof_k50.seeded_b512", True), ("_a-b.c", True), ("9x", True),
    ("a b", False), ("a,b", False), ("a/b", False), ("", False),
    ("x" * 65, False), ("µs", False), (".a", False)])
def test_name_characters(name, ok):
    if ok:
        assert cells.check_name(name) == name
    else:
        with pytest.raises(ValueError):
            cells.check_name(name)


@pytest.mark.parametrize("unit,ok", [
    ("solves/s", True), ("%", True), ("ms", True), ("iters", True),
    ("tokens per second", False), ("µs", False), ("x" * 17, False)])
def test_unit_characters(unit, ok):
    if ok:
        assert check_unit(unit) == unit
    else:
        with pytest.raises(ValueError):
            check_unit(unit)


def test_benchmark_json_shape():
    spec = _spec()
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert spec["paths"] == ["benchmark"]
    line = re.compile(r"^[^\n\t]{1,200}$")
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cells.check_name(c["name"])
        assert line.match(c["source"]) and line.match(c["why"])
        assert c["file"].startswith("benchmark/")
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            cells.check_name(w[k])
        assert w["chips"] in (1, 4) and line.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and line.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    every = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in every}) == len(every)
    for m in every:
        cells.check_name(m["name"])
        check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
