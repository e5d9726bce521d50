"""``BENCHMARK.json`` against the benchmark's contract: its keys and limits,
and the files each name leads the harness to."""

import json
import os
import re

import pytest

from h100_bench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["h100_bench"] and BENCH["command"][1] == "h100_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    # The whole check fits its allowance with the full 24 cells.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE(c["source"]) and LINE(c["why"])
        assert c["file"].startswith("h100_bench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert names == {w["config"] for w in BENCH["workloads"]}
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    c = harness.find_cell(BENCH, cell)
    here = harness.HERE
    assert os.path.exists(os.path.join(here, "drivers", f"{c.traffic['driver']}.py"))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end:
        assert os.path.exists(os.path.join(here, "end_to_end", f"{m['name']}.py"))
    for m in c.per_layer:
        assert os.path.exists(os.path.join(here, "metrics", f"{m['name']}.py"))
        assert m["moves"] in e2e  # every cell that reports it reports what it moves
    for name, limit in c.limits.items():
        assert NAME.match(name) and limit > 0
