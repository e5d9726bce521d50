"""A later change adds a configuration, a traffic mix and a metric as new
files and entries only: here a copy of the benchmark gains three files and
a cell under new names, and a CPU rehearsal runs them, with every existing
file of the benchmark left as it was."""

import hashlib
import json
import os
import shutil

from h100_bench import harness
from h100_bench.tests.tiny import tiny_cell


def _digests(folder):
    out = {}
    for d, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, folder)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_by_files_alone(tmp_path):
    root = str(tmp_path)
    shutil.copytree(harness.HERE, os.path.join(root, "h100_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(harness.manifest()))
    before = _digests(os.path.join(root, "h100_bench"))
    here = os.path.join(root, "h100_bench")

    base = tiny_cell("cifar10-32.pairs-b1")
    with open(os.path.join(here, "configs", "tiny-16.json"), "w") as f:
        json.dump(dict(base.config, name="tiny-16"), f)
    with open(os.path.join(here, "traffic", "pairs-b1-short.json"), "w") as f:
        json.dump(dict(base.traffic, timesteps=4), f)
    with open(os.path.join(here, "limits", "tiny-16.pairs-b1-short.json"), "w") as f:
        json.dump(base.limits, f)
    with open(os.path.join(here, "metrics", "pairs_traced.py"), "w") as f:
        f.write('"""Pairs in the traced slice."""\n\n\ndef read(obs):\n'
                '    return obs.trace.info.get("pairs")\n')
    bench["configs"].append({"name": "tiny-16", "source": "a test's own", "reduced": [],
                             "file": "h100_bench/configs/tiny-16.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny-16.pairs-b1-short", "config": "tiny-16",
                               "traffic": "pairs-b1-short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "pairs_traced", "unit": "pairs", "better": "higher",
                               "source": "program_counter", "layer": "sampler chain",
                               "moves": "pairs_per_s", "workloads": ["tiny-16.pairs-b1-short"]})
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append("tiny-16.pairs-b1-short")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = harness.find_cell(harness.manifest(root), "tiny-16.pairs-b1-short", root)
    assert cell.here == here and cell.traffic["timesteps"] == 4
    timed = harness.run_cell(cell, 3, 0.2, False, "cpu")
    traced = harness.run_cell(cell, 3, 0.2, True, "cpu")
    assert timed["correct"] and set(timed["metrics"]) == {
        "pairs_per_s", "peak_mem_gib", "setup_s"}
    assert traced["correct"] and traced["metrics"]["pairs_traced"]["value"] == cell.traffic["traced_calls"]
    after = _digests(here)
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == [
        "configs/tiny-16.json", "limits/tiny-16.pairs-b1-short.json", "metrics/pairs_traced.py",
        "traffic/pairs-b1-short.json"]
