"""The port's sampler profiler (``scripts/profile_sampler.py``) on the CPU,
at sf 0.1, 16x16x3, T=4, batch 2:

- ``capture``'s last traced chain equals the same ``generate_trajectory_scan``
  call without the profiler, exactly (the default draws: noise from a
  ``torch.Generator`` seeded 1, step noise from each chain's seed);
- with the port's seeded weights carried into JAX (``models/convert.py``)
  and JAX's draws injected, that chain is held to JAX's
  ``generate_trajectory_scan`` at rtol 2e-5 / atol 1e-5 (the sampler
  tolerance of ``tests/test_ops.py``), in float32;
- ``summarize`` reads a hand-made Chrome trace: rows, launch counts, busy
  time and idle share, for device kernels and for CPU operators.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion import generate_trajectory_scan as jax_scan
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_torch import Config
from distillation_trajectories_torch.diffusion import generate_trajectory_scan, get_diffusion_params
from distillation_trajectories_torch.models import make_unet, variables_from_unet_state_dict
from distillation_trajectories_torch.scripts import profile_sampler
from distillation_trajectories_torch.training import make_eval_model_fn
from distillation_trajectories_torch.utils.profiling import trace_summary
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    jax_step_noise,
    tmp_path,
)

torch.set_num_threads(2)
SMALL = dict(batch=2, device="cpu", size_factor=0.1, image_size=16, timesteps=4)
T, SHAPE = SMALL["timesteps"], (SMALL["batch"], 16, 16, 3)


def _port_chain(noise, seed, compute_dtype="bfloat16", step_noise=None):
    cfg = Config(timesteps=T, sample_steps=T, image_size=16, compute_dtype=compute_dtype,
                 device="cpu")
    fn = make_eval_model_fn(make_unet(cfg, size_factor=0.1, seed=0))
    return generate_trajectory_scan(fn, noise, T, get_diffusion_params(T, cfg)["alphas"], seed,
                                    guidance_scale=3.0, step_noise=step_noise)


def test_capture_equals_the_unprofiled_chain(tmp_path):
    path, got = profile_sampler.capture(str(tmp_path), **SMALL)
    assert path == os.path.join(str(tmp_path), profile_sampler.TRACE_NAME)
    assert os.path.getsize(path) > 0
    noise = torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
    want = _port_chain(noise, seed=3)
    assert got.shape == (T + 1, *SHAPE) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    summary = profile_sampler.summarize(str(tmp_path), top=5)
    assert not summary.on_device and summary.path == path
    assert summary.launches("aten::conv2d") > 0 and 0.0 <= summary.idle_share < 1.0


def test_capture_matches_jax_with_its_draws(tmp_path):
    noise = np.array(jax.random.normal(jax.random.PRNGKey(1), SHAPE))
    step_noise = {s: torch.from_numpy(jax_step_noise([s], T, SHAPE)[:, 0]) for s in range(4)}
    _, got = profile_sampler.capture(str(tmp_path), compute_dtype="float32",
                                     noise=torch.from_numpy(noise), step_noise=step_noise,
                                     **SMALL)
    torch.testing.assert_close(
        got, _port_chain(torch.from_numpy(noise), 3, "float32", step_noise[3]), rtol=0, atol=0)

    jcfg = JaxConfig(timesteps=T, sample_steps=T, image_size=16, compute_dtype="float32")
    tcfg = Config(timesteps=T, sample_steps=T, image_size=16, compute_dtype="float32",
                  device="cpu")
    variables = variables_from_unet_state_dict(make_unet(tcfg, size_factor=0.1, seed=0).state_dict())
    fn = jax_eval_fn(jax_make_unet(jcfg, size_factor=0.1), variables)
    want = jax_scan(fn, jnp.asarray(noise), T, jax_params(T, jcfg)["alphas"], 3,
                    guidance_scale=3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0}] + [
            {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}
            for cat, name, ts, dur in events]}, f)


@pytest.mark.parametrize("on_device", [True, False])
def test_summarize_reads_a_hand_made_trace(tmp_path, capsys, on_device):
    """Device trace: three kernels and a copy over [100, 200] µs, with a
    runtime call and a CPU op that are not rows; busy 10 + 20 + 5 + 10 =
    45 µs (the copy overlaps the second kernel by 5) of a 100 µs window.
    CPU trace: nested operators, busy their union."""
    if on_device:
        events = [("kernel", "cfg_engine_update_kernel", 100.0, 10.0),
                  ("kernel", "conv", 130.0, 20.0),
                  ("gpu_memcpy", "Memcpy HtoD", 145.0, 10.0),
                  ("kernel", "cfg_engine_update_kernel", 190.0, 10.0),
                  ("cuda_runtime", "cudaLaunchKernel", 0.0, 500.0),
                  ("cpu_op", "aten::add", 0.0, 400.0)]
        rows = [("cfg_engine_update_kernel", 2, 20.0), ("conv", 1, 20.0),
                ("Memcpy HtoD", 1, 10.0)]
        busy, window = 45.0, 100.0
    else:
        events = [("cpu_op", "aten::conv2d", 0.0, 30.0),
                  ("cpu_op", "aten::convolution", 5.0, 20.0),
                  ("cpu_op", "aten::add", 50.0, 10.0),
                  ("python_function", "run", 0.0, 100.0)]
        rows = [("aten::conv2d", 1, 30.0), ("aten::convolution", 1, 20.0),
                ("aten::add", 1, 10.0)]
        busy, window = 40.0, 60.0
    old, new = tmp_path / "old.json", tmp_path / "sub" / "new.json"
    new.parent.mkdir()
    _write_trace(old, [("kernel", "stale", 0.0, 1.0)])
    _write_trace(new, events)
    os.utime(old, (1, 1))  # summarize reads the newest trace under logdir
    summary = profile_sampler.summarize(str(tmp_path), top=2)
    assert summary == trace_summary(str(new))
    assert summary.on_device is on_device
    assert sorted(summary.rows, key=lambda r: (-r[2], r[0])) == sorted(rows, key=lambda r: (-r[2], r[0]))
    assert summary.busy_us == busy and summary.window_us == window
    assert summary.idle_share == pytest.approx(1 - busy / window)
    out = capsys.readouterr().out
    assert ("device kernels (self time)" if on_device else "CPU operators (inclusive time)") in out
    assert f"busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window" in out
    assert len([l for l in out.splitlines() if l.startswith(" " * 8)]) == 2  # top=2 rows
    if on_device:
        assert summary.launches("cfg_engine_update_kernel") == 2


def test_summarize_without_a_trace_exits(tmp_path):
    with pytest.raises(SystemExit, match="no trace"):
        profile_sampler.summarize(str(tmp_path))
