"""The port's full-sweep orchestrator
(``distillation_trajectories_torch/scripts/run_full_sweep.py``): the unit
tests of ``tests/test_run_full_sweep.py`` on the port's helpers, the CUDA
preflight abort, and one tiny CPU run of all five stages."""

import json
import os
import sys
import time

import pytest

from distillation_trajectories_torch.scripts import run_full_sweep as rfs


def test_write_speedup_math(tmp_path, monkeypatch):
    monkeypatch.setattr(rfs, "project_root", str(tmp_path))
    with open(tmp_path / ".bench_baseline.json", "w") as f:
        json.dump({"ref_traj_per_sec_cpu": 0.4}, f)
    stages = {
        "teacher": {"ok": True, "seconds": 100.0, "cmd": "t"},
        "students": {"ok": True, "seconds": 200.0, "cmd": "s"},
        "cfg_sweep": {"ok": True, "seconds": 160.0, "cmd": "c"},
        "trio": {"ok": True, "seconds": 50.0, "cmd": "tr"},
        "fid": {"ok": True, "seconds": 90.0, "cmd": "f"},
    }
    out = rfs._write("rtest", stages, ok=True)
    assert out == str(tmp_path / "SWEEP_torch_rtest.json")
    assert not (tmp_path / "SWEEP_rtest.json").exists()  # the JAX records' name
    with open(out) as f:
        payload = json.load(f)
    assert payload["ok"] is True and payload["total_seconds"] == 600.0
    # 1600 chains at T=100 = 2x the benched T=50 trajectory each.
    assert payload["reference_equiv_sweep_seconds"] == round(1600 * 2 / 0.4, 1)
    assert payload["sweep_speedup_vs_reference"] == round((1600 * 2 / 0.4) / 160.0, 1)
    wl = payload["workload"]
    assert "trio" in wl and "fid" in wl and "cfg_sweep" in wl
    assert wl["student_size_factors"] == rfs.SIZE_FACTORS


def test_preflight_aborts_without_cuda(tmp_path, monkeypatch):
    """``--device cuda`` where the preflight finds no GPU: no stage runs,
    ``ok: false`` with the preflight is written, and main returns 1."""
    down = {"status": "down", "device": "cuda", "detail": "torch.cuda.is_available() is False"}
    monkeypatch.setattr(rfs, "preflight", lambda device: dict(down))

    def boom(*a, **kw):
        raise AssertionError("stage launched without a device")

    monkeypatch.setattr(rfs, "run_stage", boom)
    assert rfs.main(["--tag", "rdead", "--base_dir", str(tmp_path)]) == 1
    with open(tmp_path / "SWEEP_torch_rdead.json") as f:
        payload = json.load(f)
    assert payload["ok"] is False and payload["preflight_probe"]["status"] == "down"
    assert payload["device"] == "cuda"


def test_preflight_without_cuda_exits_1_for_real(tmp_path):
    """Where torch has no CUDA, ``--device cuda`` fails the real preflight."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a GPU")
    assert rfs.preflight("cpu")["status"] == "ok"
    assert rfs.main(["--tag", "nocuda", "--base_dir", str(tmp_path)]) == 1
    with open(tmp_path / "SWEEP_torch_nocuda.json") as f:
        payload = json.load(f)
    assert payload["ok"] is False and payload["stages"] == {}
    assert "is_available() is False" in payload["preflight_probe"]["detail"]


class _Proc:
    def __init__(self, rc=0):
        self.returncode = rc


def test_retry_appends_extra_args_and_aborts_when_down(tmp_path, monkeypatch):
    monkeypatch.setattr(rfs, "preflight", lambda device: {"status": "ok", "detail": "fine"})
    calls = []

    def fake_run(cmd, **kw):
        calls.append(list(cmd))
        return _Proc(1 if len(calls) == 1 else 0)

    monkeypatch.setattr(rfs.subprocess, "run", fake_run)
    out = rfs.run_stage("students", ["python", "train.py"], str(tmp_path), retries=1,
                        retry_extra_args=["--skip_existing"])
    assert out["ok"] is True
    assert calls == [["python", "train.py"], ["python", "train.py", "--skip_existing"]]
    log = (tmp_path / "sweep_students.log").read_text()
    assert "===== attempt 1 =====" in log and "===== attempt 2 =====" in log

    # A failed preflight before the retry: no second launch.
    monkeypatch.setattr(rfs, "preflight", lambda device: {"status": "down", "detail": "gone"})
    calls.clear()

    def always_fail(cmd, **kw):
        calls.append(list(cmd))
        return _Proc(1)

    monkeypatch.setattr(rfs.subprocess, "run", always_fail)
    out = rfs.run_stage("students", ["python", "train.py"], str(tmp_path), retries=1,
                        device="cuda")
    assert out["ok"] is False and len(calls) == 1


def test_job_marginal_parses_last_attempt(tmp_path):
    log = tmp_path / "sweep_cfg_trio.log"
    log.write_text(
        "===== attempt 1 =====\n"
        "[jobs] job 1 (trio): marginal 99.9s\n"
        "===== attempt 2 =====\n"
        "[jobs] job 0 (heatmaps): marginal 30.2s\n"
        "[jobs] job 1 (trio): marginal 12.3s\n"
    )
    assert rfs._job_marginal(str(log), label="trio") == 12.3
    assert rfs._job_marginal(str(log), label="heatmaps") == 30.2
    log.write_text(log.read_text() + "===== attempt 3 =====\n")
    assert rfs._job_marginal(str(log), label="trio") == 0.0
    assert rfs._job_marginal(str(log), label="heatmaps") == 0.0
    log2 = tmp_path / "filtered.log"
    log2.write_text("[jobs] job 0 (trio): marginal 7.5s\n")
    assert rfs._job_marginal(str(log2), label="trio") == 7.5
    assert rfs._job_marginal(str(log), label="nope") == 0.0
    assert rfs._job_marginal(str(tmp_path / "nope.log"), label="trio") == 0.0


def test_embed_students_phases(tmp_path):
    phases = {
        "students/teacher_load": {"count": 1, "total_s": 1.5, "mean_s": 1.5},
        "students/dataset": {"count": 1, "total_s": 7.0, "mean_s": 7.0},
        "students/grid": {"count": 13, "total_s": 40.0, "mean_s": 3.1},
        "distill_epoch_sf0.1": {"count": 5, "total_s": 2.0, "mean_s": 0.4},
        "distill_epoch_sf0.5": {"count": 5, "total_s": 3.0, "mean_s": 0.6},
        "teacher_epoch": {"count": 1, "total_s": 9.9, "mean_s": 9.9},
    }
    p = tmp_path / "students_phase_times.json"
    p.write_text(json.dumps(phases))
    rec = {"ok": True, "seconds": 100.0}
    rfs._embed_students_phases(str(tmp_path), rec)
    assert rec["phases"] == {"train_epochs_s": 5.0, "teacher_load_s": 1.5, "dataset_s": 7.0,
                             "grid_s": 40.0}
    old = time.time() - 10_000  # a dump older than the stage is not embedded
    os.utime(p, (old, old))
    rec2 = {"ok": True, "seconds": 100.0}
    rfs._embed_students_phases(str(tmp_path), rec2)
    assert "phases" not in rec2


def test_run_stage_passes_env_extra(tmp_path, monkeypatch):
    seen = {}

    def fake_run(cmd, **kw):
        seen.update(kw)
        return _Proc()

    monkeypatch.setattr(rfs.subprocess, "run", fake_run)
    out = rfs.run_stage("fid", ["python", "x.py"], str(tmp_path),
                        env_extra={"PYTHONUNBUFFERED": "1"})
    assert out["ok"] is True
    assert seen["env"]["PYTHONUNBUFFERED"] == "1" and "PATH" in seen["env"]
    assert seen["cwd"] == rfs.project_root
    rfs.run_stage("teacher", ["python", "x.py"], str(tmp_path))
    assert seen["env"] is None


def test_tiny_cpu_run_of_all_five_stages(tmp_path, monkeypatch):
    """Every stage for real, as subprocesses on the CPU: 16x16 MNIST-shaped
    data, two students, T=10 everywhere, a few samples; matplotlib hidden
    from the stages, as on the GPU machine, so the CLIs skip their plots."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the stages share the test workers' cores
    hidden = tmp_path / "no_matplotlib" / "matplotlib"
    hidden.mkdir(parents=True)
    (hidden / "__init__.py").write_text('raise ImportError("hidden from the sweep stages")\n')
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(hidden.parent)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    small = ["--timesteps", "10"]
    monkeypatch.setattr(rfs, "STAGE_ARGS", {
        "teacher": small + ["--batch_size", "8", "--num_samples", "2"],
        "students": small + ["--batch_size", "8", "--num_samples", "2"],
        "cfg_trio": small + ["--num_samples", "2", "--guidance_scales", "1.0,3.0"],
        "fid": small + ["--num_samples", "4"],
    })
    monkeypatch.setattr(rfs, "CFG_JOBS", [
        {"output_dir": "analysis/heatmaps"},
        {"size_factors": "0.1,0.5,0.9", "timesteps": 6, "output_dir": "analysis/trio"},
    ])
    rc = rfs.main(["--tag", "tiny", "--device", "cpu", "--base_dir", str(tmp_path),
                   "--dataset", "MNIST", "--image_size", "16", "--limit_batches", "1",
                   "--epochs_teacher", "1", "--epochs_students", "1",
                   "--size_factors", "0.1,0.2"])
    with open(tmp_path / "SWEEP_torch_tiny.json") as f:
        payload = json.load(f)
    logs = tmp_path / "output" / "results"
    assert rc == 0, {p.name: p.read_text()[-2000:] for p in logs.glob("sweep_*.log")}
    assert payload["ok"] is True and payload["device"] == "cpu"
    assert set(payload["stages"]) == {"teacher", "students", "cfg_sweep", "trio", "fid"}
    assert all(s["ok"] for s in payload["stages"].values())
    assert payload["stages"]["students"]["phases"]["train_epochs_s"] >= 0
    assert "python -m distillation_trajectories_torch.scripts.train_teacher" in \
        payload["stages"]["teacher"]["cmd"].replace(sys.executable, "python")
    models = tmp_path / "output" / "models"
    assert (models / "teacher" / "model_epoch_1.msgpack").exists()
    for sf in ("0.1", "0.2"):
        assert (models / "students" / f"size_{sf}" / "model_epoch_1.msgpack").exists()
    with open(tmp_path / "output" / "analysis" / "fid" / "fid_summary.json") as f:
        assert sorted(json.load(f)["fid_by_size"]) == ["0.1", "0.2"]
    cfg_log = (logs / "sweep_cfg_trio.log").read_text()
    assert "[jobs] job 1 (trio): marginal" in cfg_log
    assert "plots skipped" in cfg_log and "plots skipped" in (logs / "sweep_fid.log").read_text()


def test_skip_training_keeps_the_training_records(tmp_path, monkeypatch):
    monkeypatch.setattr(rfs, "preflight", lambda device: {"status": "ok", "detail": "fine"})
    launched = []

    def fake_stage(name, cmd, log_dir, **kw):
        launched.append((name, cmd))
        return {"ok": True, "seconds": 1.0, "cmd": " ".join(cmd)}

    monkeypatch.setattr(rfs, "run_stage", fake_stage)
    old = {"teacher": {"ok": True, "seconds": 5.0, "cmd": "t"},
           "students": {"ok": True, "seconds": 7.0, "cmd": "s"},
           "cfg_sweep": {"ok": False, "seconds": 9.0, "cmd": "c"}}
    (tmp_path / "SWEEP_torch_r1.json").write_text(json.dumps({"stages": old}))
    assert rfs.main(["--tag", "r1", "--skip-training", "--base_dir", str(tmp_path)]) == 0
    assert [name for name, _ in launched] == ["cfg_trio", "fid"]
    cfg_cmd = launched[0][1]
    assert cfg_cmd[1:3] == ["-m", "distillation_trajectories_torch.scripts.analyze_trajectory_metrics"]
    assert json.loads(cfg_cmd[cfg_cmd.index("--jobs") + 1]) == rfs.CFG_JOBS
    for flag, value in (("--device", "cuda"), ("--dataset", "CIFAR10"), ("--image_size", "32"),
                        ("--base_dir", str(tmp_path))):
        assert cfg_cmd[cfg_cmd.index(flag) + 1] == value
    fid_cmd = launched[1][1]
    assert fid_cmd[fid_cmd.index("--size_factors") + 1] == rfs.SIZE_FACTORS
    payload = json.loads((tmp_path / "SWEEP_torch_r1.json").read_text())
    assert payload["stages"]["teacher"] == old["teacher"]
    assert payload["stages"]["students"] == old["students"]
    assert payload["stages"]["cfg_sweep"]["ok"] is True and payload["ok"] is True
