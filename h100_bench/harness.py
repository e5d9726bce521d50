"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs set-up, the closed-loop window, the traced slice and the check, and
builds the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under this folder, found by name:

* ``configs/<config>.json``: the configuration's sizes, as run;
* ``traffic/<traffic>.json``: the mix's parameters; its ``"driver"`` names
  the general generator in ``drivers/<driver>.py`` that reads it;
* ``limits/<cell>.json``: the limit of each number the check compares;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric, ``read(window)`` and ``read(observation) -> float | None``.

A driver module has ``setup(ctx) -> run object`` with ``call(k) ->
(units, ok)``, ``call_flops`` (the U-Net FLOPs of one call), ``slice() -> info`` (the traced slice; what it did),
``release()`` (frees the program's state, keeps what the window produced)
and ``check() -> [(name, value, limit)]`` (the reference's verdict).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "distillation_trajectories_tpu")


class NoCard(RuntimeError):
    """The host lacks the cards a cell asks for."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module from a file, by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def bench_dir(root: str) -> str:
    return os.path.join(root, os.path.basename(HERE))


@dataclasses.dataclass
class Cell:
    name: str
    here: str  # the benchmark folder its files were found in
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the manifest ``bench``, its files read from the
    checkout at ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    here = bench_dir(root)
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(here, "limits", f"{name}.json"))
    return Cell(name, here, int(w["chips"]), config, traffic, limits,
                _for_cell(bench["end_to_end"], name), _for_cell(bench["per_layer"], name))


def check_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark measures the card "
                     "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the seed, the device and a work
    directory under ``TMPDIR`` (removed when the run ends).  ``control``
    names a driver's lower-precision control or a fault read in the
    reference's place (``readings.py`` and the tests only; the benchmark's
    own runs pass none)."""

    cell: Cell
    seed: int
    seconds: float
    device: torch.device
    workdir: str
    control: Optional[str] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Window:
    """What the closed loop did: each call's units, seconds and U-Net FLOPs
    (counted from the shapes by the driver).  ``peak_bytes`` is the
    allocator's reserved peak over set-up and the window, or, where the
    traffic sets ``peak_after_calls``, over set-up and that many of the
    window's calls (a cell whose reserve grows call by call then reads the
    same peak however many calls its window holds); ``device_peak_bytes``
    is the peak over the whole run."""

    unit_counts: List[int]
    seconds: List[float]
    ok: List[bool]
    flops: List[float]
    setup_s: float
    peak_bytes: int
    device_peak_bytes: int


@dataclasses.dataclass
class Observation:
    """What a per-layer reader reads: the traced slice and the window."""

    trace: object
    window: Window


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, control: Optional[str] = None,
             details: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result object (without printing).
    ``details``, where given, receives what the check saw besides its
    numbers (each compared quantity's own gap)."""
    t_start = time.perf_counter() if t_start is None else t_start
    here = cell.here
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    driver = load_file(os.path.join(here, "drivers", f"{cell.traffic['driver']}.py"),
                       f"h100_bench_driver_{cell.traffic['driver']}")
    workdir = tempfile.mkdtemp(prefix="h100_bench_")
    try:
        ctx = Context(cell, int(seed), float(seconds), device, workdir, control)
        if device.type == "cuda":
            torch.zeros(1, device=device)  # the allocator's statistics exist from here
            torch.cuda.reset_peak_memory_stats(device)
        run = driver.setup(ctx)
        _sync(device)
        setup_s = time.perf_counter() - t_start

        peak_of = lambda: torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
        peak_after = cell.traffic.get("peak_after_calls")
        peak_at = None
        units, secs, oks, flops = [], [], [], []
        start = time.perf_counter()
        k = 0
        while time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            n, ok = run.call(k)
            _sync(device)
            secs.append(time.perf_counter() - t0)
            units.append(int(n))
            oks.append(bool(ok))
            flops.append(float(run.call_flops))
            k += 1
            if k == peak_after:
                peak_at = peak_of()
        peak = peak_of()
        window = Window(units, secs, oks, flops, setup_s, int(peak if peak_at is None else peak_at),
                        int(peak))

        metrics, traced, breakdown = {}, None, None
        if trace:
            from .yardstick.trace import trace_slice

            traced = trace_slice(run.slice, device)
            for m in cell.per_layer:
                reader = load_file(os.path.join(here, "metrics", f"{m['name']}.py"),
                                   f"h100_bench_metric_{m['name']}")
                value = reader.read(Observation(traced, window))
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            breakdown = {"device_ops": traced.top_device_ops(),
                         "idle_gaps": traced.top_idle_gaps()}
        else:
            for m in cell.end_to_end:
                reader = load_file(os.path.join(here, "end_to_end", f"{m['name']}.py"),
                                   f"h100_bench_e2e_{m['name']}")
                metrics[m["name"]] = {"value": float(reader.read(window)), "unit": m["unit"]}

        run.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = run.check()
        if details is not None:
            details.update(getattr(run, "details", {}))
        del run
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    correct = bool(checks) and all(
        isinstance(v, float) and math.isfinite(v) and v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": window.device_peak_bytes}
    if traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
    result = {"correct": correct and all(window.ok), "attempted": len(window.ok),
              "failed": sum(not ok for ok in window.ok), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result
