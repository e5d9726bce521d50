"""CPU rehearsals of every traffic file's control flow, the faults the
check must catch, the refusal of a host without the card, and the JAX
guard."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from h100_bench import harness
from h100_bench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEED = 2 ** 31 + 2 ** 20 + 17  # more than 32 signed bits hold


def _run(name, trace=False, seconds=0.3, **kw):
    return harness.run_cell(tiny_cell(name), SEED, seconds, trace, "cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_end_to_end(name):
    r = _run(name)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    cell = harness.find_cell(harness.manifest(), name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(math.isfinite(m["value"]) for m in r["metrics"].values())
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_traced(name):
    r = _run(name, trace=True)
    assert r["correct"] is True
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device events on the CPU: the readers return nothing, so no
    # device metric is written from a CPU run.
    assert r["metrics"] == {}


def _fault(monkeypatch, target, attr, make):
    monkeypatch.setattr(target, attr, make(getattr(target, attr)))


def _frozen_update(orig):
    return lambda x, uncond, cond, noise, row: x.clone()


def _half_batch_metrics(orig):
    def metrics(t, s, uniforms=None, *a):
        out = orig(t, s, uniforms, *a)
        half = t.shape[0] // 2
        return {k: (torch.cat([v[:half], v[:half]]) if v.ndim == 1 else v) for k, v in out.items()}
    return metrics


def _altered_metrics(orig):
    def metrics(*a, **k):
        out = orig(*a, **k)
        out["endpoint_distance"] = out["endpoint_distance"] * 1.05
        return out
    return metrics


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_sweep_faults_are_caught(monkeypatch, fault):
    from distillation_trajectories_torch.diffusion import sampling
    from distillation_trajectories_torch.trajectories import engine

    if fault == "state_unchanged":
        _fault(monkeypatch, sampling, "cfg_engine_update_row", _frozen_update)
    elif fault == "half_batch":
        _fault(monkeypatch, engine, "batch_metrics_core", _half_batch_metrics)
    else:
        _fault(monkeypatch, engine, "batch_metrics_core", _altered_metrics)
    assert _run("cifar10-32.sweep")["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_pairs_faults_are_caught(monkeypatch, fault):
    from distillation_trajectories_torch.diffusion import sampling
    from distillation_trajectories_torch.trajectories import manager

    if fault == "state_unchanged":
        _fault(monkeypatch, sampling, "cfg_engine_update_row", _frozen_update)
    else:
        def altered(orig):
            def gen(self, *a, **k):
                t, s = orig(self, *a, **k)
                s = s.copy()
                s[-1] *= 1.05
                return t, s
            return gen
        _fault(monkeypatch, manager.TrajectoryManager, "generate_trajectory_from_sample", altered)
    assert _run("cifar10-32.pairs-b1")["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "rows_stale"])
def test_train_faults_are_caught(monkeypatch, fault):
    from distillation_trajectories_torch.data.datasets import DataLoader
    from distillation_trajectories_torch.training import state

    if fault == "rows_stale":
        # Every step of an epoch trains on its first batch's rows.
        def stale(orig):
            def epoch_indices(self, *a, **k):
                idx = orig(self, *a, **k)
                return idx[:1].repeat(len(idx), 0)
            return epoch_indices
        _fault(monkeypatch, DataLoader, "epoch_indices", stale)
    elif fault == "state_unchanged":
        def no_step(orig):
            def update(st, loss, ema_rate):
                st.optimizer.zero_grad(set_to_none=False)
                loss.backward()
            return update
        _fault(monkeypatch, state, "_update", no_step)
    elif fault == "half_batch":
        _fault(monkeypatch, state, "_mse",
               lambda orig: lambda a, b: orig(a[: a.shape[0] // 2], b[: b.shape[0] // 2]))
    else:
        _fault(monkeypatch, state, "_global_loss", lambda orig: lambda st, loss: orig(st, loss) * 1.05)
    assert _run("mnist-16.train")["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mnist-16.train", "cifar10-32.train"])
def test_train_graph_counter_stuck_is_caught_on_the_card(card, monkeypatch, name):
    """The window's captured step with its batch counter left unadvanced:
    every replay trains on the row of the first replayed batch."""
    from distillation_trajectories_torch.training import state
    from distillation_trajectories_torch.utils.graphs import capture

    def stuck(self, body):
        def step():
            at = self.i.view(1)
            loss = body(self.state, self.dataset.index_select(0, self.idx.index_select(0, at)[0]))
            self.losses.index_copy_(0, at, loss.unsqueeze(0))
        self.graph, _ = capture(step, generators=state._draw_generators(self.state))

    monkeypatch.setattr(state._CapturedStep, "capture", stuck)
    cell = harness.find_cell(harness.manifest(), name)
    assert harness.run_cell(cell, 31_337, 1.0, False, card)["correct"] is False


CONTROLS = [("cifar10-32.sweep", "program_int8"), ("cifar10-32.pairs-b1", "program_int8"),
            ("mnist-16.train", "reference_fp8"), ("cifar10-32.train", "reference_fp8")]


@pytest.mark.parametrize("name, control", CONTROLS)
def test_controls_are_wired(name, control):
    """At a size the CPU holds, each control reads each compared number far
    above the float32 program's (which the limits are not set for: they
    come from the card, bf16 against float32, at the cell's own size)."""
    sound = _run(name)["checks"]
    low = _run(name, control=control)["checks"]
    assert max(c["value"] / max(sound[k]["value"], 1e-12) for k, c in low.items()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("name, control", CONTROLS)
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 3, 7_000_001])
def test_controls_fail_on_the_card(card, name, control, seed):
    """The control at the cell's own size on the card comes out as not
    correct (a short window: the check is what is read)."""
    cell = harness.find_cell(harness.manifest(), name)
    assert harness.run_cell(cell, seed, 1.0, False, card, control=control)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cells_are_correct_on_the_card(card, name):
    cell = harness.find_cell(harness.manifest(), name)
    r = harness.run_cell(cell, 12_345, 2.0, False, card)
    assert r["correct"] is True, r["checks"]


def _command(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "h100_bench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_refuses_a_host_without_the_card():
    p = _command(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                 harness.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in p.stderr


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "distillation_trajectories_torch" in p.stderr


def test_no_jax_after_a_rehearsal():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from h100_bench import harness\n"
        "from h100_bench.tests.tiny import tiny_cell\n"
        "for name in %r:\n"
        "    harness.run_cell(tiny_cell(name), 5, 0.2, True, 'cpu')\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % (harness.ROOT, CELLS))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-2000:]
    found, loaded = (eval(line) for line in p.stdout.strip().splitlines()[-2:])
    assert found == []
    assert "distillation_trajectories_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "distillation_trajectories_tpu"} & set(loaded)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]
