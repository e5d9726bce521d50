"""The port's span recorder (``utils/profiling.py``): nothing kept with
recording off, and on the CPU the spans of a sweep call, a paired call and
an epoch on the epoch lane, nested under their call, on the Unix clock;
``phase_timer`` still fills the phase registry the full sweep reads.  The
card's spans (the sampler graphs', the epoch's capture) are tested in
``test_torch_cuda.py``."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.data.datasets import DataLoader
from distillation_trajectories_torch.diffusion.schedules import get_diffusion_params
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.scripts import run_full_sweep
from distillation_trajectories_torch.training import loop
from distillation_trajectories_torch.training import state as port_state
from distillation_trajectories_torch.trajectories import TrajectoryManager
from distillation_trajectories_torch.trajectories.engine import sweep_compare_trajectories_multi
from distillation_trajectories_torch.utils import profiling
from torch_parity import tmp_path  # noqa: F401  (each test's outputs removed when it ends)

torch.set_num_threads(2)

KW = dict(dataset="MNIST", image_size=16, channels=1, batch_size=4, timesteps=4,
          teacher_steps=4, compute_dtype="float32", dropout=0.0, device="cpu")


def _recorded(fn):
    """``(fn(), spans by name, every span)``, each span checked to lie within
    the Unix clock read before and after the call."""
    t0 = time.time_ns()
    with profiling.recording() as rec:
        out = fn()
    t1 = time.time_ns()
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert spans and all(t0 <= s.start_ns <= s.end_ns <= t1 for s in spans)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    return out, by_name, spans


def _inside(child, parent):
    return (child.parent == parent.id and child.call == parent.id
            and parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns)


def test_off_returns_the_shared_no_op_and_keeps_nothing():
    assert profiling._RECORDING is None
    first, second = profiling.span("draws", n=3), profiling.span("sweep.call")
    assert first is second is profiling._NOOP
    with first, second:
        pass
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and profiling._RECORDING is None


def test_spans_nest_per_thread_and_stop_with_the_recording():
    def worker():
        with profiling.span("pairs.call", seed=7):
            with profiling.span("draws", n=1):
                pass

    with profiling.recording() as rec:
        with profiling.span("sweep.call", jobs=1, pairs=2):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=30)
            assert not thread.is_alive()
    with profiling.span("draws", n=2):
        pass
    spans = {s.name: s for s in rec.spans}
    assert len(rec.spans) == 3
    assert spans["pairs.call"].parent is None and spans["pairs.call"].thread != spans[
        "sweep.call"].thread
    assert _inside(spans["draws"], spans["pairs.call"])
    assert spans["sweep.call"].attrs == {"jobs": 1, "pairs": 2}


def test_spans_of_many_threads_are_all_kept_with_their_own_parents():
    """More threads than cores open nested spans with a short switch
    interval: no span is lost, ids are unique and each child's parent is
    its own thread's outer span."""
    threads_n, each = 2 * (os.cpu_count() or 4), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for i in range(each):
                with profiling.span("pairs.call", seed=i):
                    with profiling.span("draws", n=1):
                        pass

        with profiling.recording() as rec:
            threads = [threading.Thread(target=worker) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(rec.spans) == 2 * threads_n * each
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    calls = {s.id: s for s in rec.spans if s.name == "pairs.call"}
    for s in rec.spans:
        if s.name == "draws":
            parent = calls[s.parent]
            assert parent.thread == s.thread and s.call == parent.id
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_sweep_call_records_draws_and_metrics_inside_it(tmp_path):
    cfg = Config(base_dir=str(tmp_path), **KW)
    teacher = make_unet(cfg, size_factor=0.2, seed=0, device="cpu")
    students = {0.1: make_unet(cfg, size_factor=0.1, seed=1, device="cpu")}
    job = {"students": students, "guidance_scales": (1.0, 3.0), "num_samples": 2,
           "base_seed": 5, "timesteps": 4}
    run = lambda: sweep_compare_trajectories_multi(teacher, [job], cfg, device="cpu",  # noqa
                                                   verbose=False)
    out, by_name, spans = _recorded(run)
    assert out == run()  # recording changes no result
    (call,) = by_name["sweep.call"]
    assert call.attrs == {"jobs": 1, "pairs": 4} and call.parent is None
    # 16x16x1 is 256 pixels, the Wasserstein subsample's size: no uniforms
    # draw; the starting noise (2 keys) and the step noise (3 steps x 2).
    assert [s.attrs["n"] for s in by_name["draws"]] == [2, 6]
    # The CFG chains run first, then the CFG-off ones.
    assert [(s.attrs["sf"], s.attrs["gs"]) for s in by_name["sweep.metrics"]] == [
        (0.1, 3.0), (0.1, 1.0)]
    assert all(_inside(s, call) for s in by_name["draws"] + by_name["sweep.metrics"])
    assert {s.call for s in spans} == {call.id}
    assert not any(s.name.startswith("graph.") for s in spans)  # the CPU captures nothing


def test_sweep_call_records_its_makers_inside_it(tmp_path):
    """One ``sweep.makers`` span inside each ``sweep.call``: the first call
    builds the teacher's and the student's makers, the second finds both
    resident."""
    cfg = Config(base_dir=str(tmp_path), **KW)
    teacher = make_unet(cfg, size_factor=0.2, seed=0, device="cpu")
    job = {"students": {0.1: make_unet(cfg, size_factor=0.1, seed=1, device="cpu")},
           "guidance_scales": (1.0, 3.0), "num_samples": 2, "base_seed": 5, "timesteps": 4}
    attrs = []
    for _ in range(2):
        _, by_name, _ = _recorded(lambda: sweep_compare_trajectories_multi(
            teacher, [job], cfg, device="cpu", verbose=False))
        (call,), (makers,) = by_name["sweep.call"], by_name["sweep.makers"]
        assert _inside(makers, call)
        assert makers.end_ns <= min(s.start_ns for s in by_name["sweep.metrics"])
        attrs.append(makers.attrs)
    assert attrs == [{"built": 2, "reused": 0}, {"built": 0, "reused": 2}]


def test_sweep_records_the_uniforms_draw_past_the_subsample_size(tmp_path):
    cfg = Config(base_dir=str(tmp_path), **dict(KW, image_size=32, channels=3))
    teacher = make_unet(cfg, size_factor=0.1, seed=0, device="cpu")
    job = {"students": {0.1: teacher}, "guidance_scales": (1.0,), "num_samples": 1,
           "base_seed": 5, "timesteps": 3}
    _, by_name, _ = _recorded(lambda: sweep_compare_trajectories_multi(
        teacher, [job], cfg, device="cpu", verbose=False))
    (call,) = by_name["sweep.call"]
    assert [s.attrs["n"] for s in by_name["draws"]] == [1, 2, 1]
    assert all(_inside(s, call) for s in by_name["draws"])


def test_paired_call_records_draws_and_copy_back(tmp_path):
    cfg = Config(base_dir=str(tmp_path), **KW)
    manager = TrajectoryManager(make_unet(cfg, size_factor=0.2, seed=0, device="cpu"),
                                make_unet(cfg, size_factor=0.1, seed=1, device="cpu"), cfg,
                                size_factor=0.1, device="cpu")
    (teacher, student), by_name, spans = _recorded(lambda: manager.generate_trajectory(seed=3))
    assert teacher.shape == student.shape == (5, 16, 16, 1)
    (call,) = by_name["pairs.call"]
    assert call.attrs == {"seed": 3}
    assert [s.attrs["n"] for s in by_name["draws"]] == [1, 3]  # the start, T-1 steps
    (to_host,) = by_name["pairs.to_host"]
    assert all(_inside(s, call) for s in by_name["draws"] + [to_host])
    assert to_host.start_ns >= max(s.end_ns for s in by_name["draws"])
    assert {s.call for s in spans} == {call.id}


def test_epoch_lane_records_the_epoch_and_its_loss_fetch(tmp_path):
    cfg = Config(base_dir=str(tmp_path), **KW)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (12, 16, 16, 1)).astype(np.float32)
    loader = DataLoader(images, np.zeros(12, np.int32), 4, shuffle=True, seed=1)
    state = port_state.create_train_state(make_unet(cfg, 0.1, seed=0, device="cpu"), cfg,
                                          port_state.TorchDraws(0, "cpu"))
    epoch_fn = port_state.make_teacher_epoch_fn(get_diffusion_params(4, cfg), 4)
    run = lambda: loop.run_train_epoch(  # noqa: E731
        state, train_step=None, loader=loader, config=cfg, device="cpu", progress_desc="",
        log_label="", log_every=0, use_scan=True, epoch_fn=epoch_fn,
        dataset_dev=loop.upload_dataset(loader, "cpu"))
    (_, loss, n), by_name, spans = _recorded(run)
    assert n == 3 and np.isfinite(loss)
    (epoch,) = by_name["train.epoch"]
    (fetch,) = by_name["train.loss_fetch"]
    assert epoch.attrs == {"batches": 3} and _inside(fetch, epoch)
    # The CPU runs the epoch eagerly: no warm-up, capture or replay spans.
    assert {s.name for s in spans} == {"train.epoch", "train.loss_fetch"}


def test_phase_timer_fills_the_registry_the_full_sweep_reads(tmp_path):
    profiling.reset_phase_times()
    try:
        with profiling.recording() as rec:
            for name in ("students/dataset_upload", "distill_epoch_sf0.1", "distill_epoch_sf0.1"):
                with profiling.phase_timer(name):
                    pass
        with profiling.phase_timer("students/ckpt_flush"):  # recording or not
            pass
        times = profiling.phase_times()
        assert times["distill_epoch_sf0.1"]["count"] == 2
        assert [s.name for s in rec.spans] == ["students/dataset_upload",
                                               "distill_epoch_sf0.1", "distill_epoch_sf0.1"]
        profiling.dump_phase_times(str(tmp_path / "students_phase_times.json"))
        record = {"seconds": 10.0}
        run_full_sweep._embed_students_phases(str(tmp_path), record)
        assert set(record["phases"]) == {"train_epochs_s", "dataset_upload_s", "ckpt_flush_s"}
        with open(tmp_path / "students_phase_times.json") as f:
            assert set(json.load(f)) == set(times)
    finally:
        profiling.reset_phase_times()


@pytest.mark.parametrize("name", ["profile_trace", "add_phase_time"])
def test_instruments_nothing_read_are_gone(name):
    assert not hasattr(profiling, name)
