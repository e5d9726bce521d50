"""The port's bench entry point (``distillation_trajectories_torch/scripts/bench.py``):
the six ledger contracts of ``tests/test_bench_ledger.py`` against the
port's ledger; the main path's chain held to JAX ``generate_trajectory_scan``
(float32, JAX's noise and step noise; rtol 2e-5 / atol 1e-5, as
``tests/test_ops.py`` holds sampler trajectories); the metric suite's sums
held to JAX's vmapped ``_metrics_core`` with JAX's subsample keys (1e-4);
the CPU run through ``main``; the stale exit without a card;
``conv_flops`` against a hand count; and every bench raising without a
card when no ``--device cpu`` is given."""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.sampling import generate_trajectory_scan as jax_scan
from distillation_trajectories_tpu.metrics.trajectory_metrics import _metrics_core
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.scripts import (
    bench,
    bench_fast,
    bench_progressive,
    bench_quant,
    bench_r2,
)
from distillation_trajectories_torch.utils.profiling import conv_flops
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    JaxBenchDraws,
    jax_variables,
    tmp_path,
)

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--batch", "2", "--timesteps", "4", "--size_factor", "0.1",
        "--image_size", "16", "--iters", "1", "--pairs", "2", "--compute_dtype", "float32"]


@pytest.fixture()
def port_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setattr(bench, "CACHE", str(tmp_path / "baseline.json"))
    return bench


def test_ledger_roundtrip(port_bench):
    assert port_bench._ledger_last() is None
    port_bench._ledger_append({"ts": 1.0, "value": 900.0})
    port_bench._ledger_append({"ts": 2.0, "value": 905.5, "vs_baseline": 2100.0})
    last = port_bench._ledger_last()
    assert last["value"] == 905.5 and last["vs_baseline"] == 2100.0


def test_ledger_corrupt_tail_returns_none(port_bench):
    with open(port_bench.LEDGER, "w") as f:
        f.write('{"ts": 1.0, "value": 1.0}\nnot json\n')
    assert port_bench._ledger_last() is None


def test_stale_exit_with_history(port_bench, capsys):
    ts = time.time() - 3600.0
    port_bench._ledger_append({"ts": ts, "ts_iso": "2026-08-18T00:00:00+0000", "value": 640.5,
                               "vs_baseline": 2100.0, "preflight": {"status": "ok"}})
    with pytest.raises(SystemExit) as exc:
        port_bench._emit_stale_and_exit("no card: torch.cuda.is_available() is False")
    assert exc.value.code == 3
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["stale"] is True and rec["value"] == 640.5 and rec["vs_baseline"] == 2100.0
    assert rec["stale_age_s"] == pytest.approx(3600.0, abs=60.0)
    assert "no card" in rec["error"]


def test_ledger_skips_unhealthy_records(port_bench):
    port_bench._ledger_append({"ts": 1.0, "value": 640.5, "preflight": {"status": "ok"}})
    port_bench._ledger_append({"ts": 2.0, "value": 9.7, "preflight": {"status": "down"}})
    port_bench._ledger_append({"ts": 3.0, "value": 3.1, "preflight": {"status": "skipped"}})
    assert port_bench._ledger_last()["value"] == 640.5
    port_bench._ledger_append({"ts": 4.0, "value": 641.1, "preflight": {"status": "up"}})
    assert port_bench._ledger_last()["value"] == 641.1
    port_bench._ledger_append({"ts": 5.0, "value": 642.2})
    assert port_bench._ledger_last()["value"] == 642.2


def test_stale_exit_all_unhealthy_is_no_history(port_bench, capsys):
    port_bench._ledger_append({"ts": 1.0, "value": 3.1, "preflight": {"status": "skipped"}})
    with pytest.raises(SystemExit) as exc:
        port_bench._emit_stale_and_exit("no card; only host history")
    assert exc.value.code == 3
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["stale"] is True and rec["value"] is None


def test_stale_exit_without_history(port_bench, capsys):
    with pytest.raises(SystemExit) as exc:
        port_bench._emit_stale_and_exit("no card, no history")
    assert exc.value.code == 3
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["stale"] is True and rec["value"] is None


def test_main_path_chain_matches_jax():
    """``bench_main_path`` in float32 on JAX's draws: its last timed chain
    (seed 1) is JAX's chain of the same weights, noise and seed."""
    args = bench.parse_args(TINY)
    value, seconds, traj, eager_seconds = bench.bench_main_path(args, JaxBenchDraws())
    assert value > 0 and len(seconds) == len(eager_seconds) == 1
    assert traj.shape == (5, 2, 16, 16, 3)
    jcfg = JaxConfig(image_size=16, timesteps=4, sample_steps=4, compute_dtype="float32")
    port = make_unet(Config(image_size=16, compute_dtype="float32", device="cpu"),
                     size_factor=0.1, seed=0)
    fn = jax_eval_fn(jax_make_unet(jcfg, size_factor=0.1), jax_variables(port))
    noise = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16, 3))
    want = jax_scan(fn, noise, 4, jax_params(4, jcfg)["alphas"], 1, guidance_scale=3.0)
    np.testing.assert_allclose(traj.numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)


def test_metric_suite_sums_match_jax():
    """The metric suite's per-metric sums over 2 pairs of 32x32x3 (3,072
    pixels: the Wasserstein subsample of 1,000 uses the keys) on JAX's
    draws, held to JAX's vmapped ``_metrics_core`` sums at 1e-4."""
    args = bench.parse_args(["--device", "cpu", "--timesteps", "4", "--image_size", "32",
                             "--pairs", "2"])
    pairs_per_s, sums = bench.bench_metric_suite(args, JaxBenchDraws())
    assert pairs_per_s > 0
    t_trajs = jax.random.normal(jax.random.PRNGKey(0), (2, 5, 32, 32, 3))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)  # the last trial's
    out = jax.vmap(_metrics_core)(t_trajs, t_trajs + 0.1, keys)
    for k, v in out.items():
        want = float(jnp.sum(v.astype(jnp.float32)))
        if np.isnan(want):
            assert np.isnan(sums[k]), k
        else:
            np.testing.assert_allclose(sums[k], want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_main_on_the_cpu_writes_the_record_and_the_ledger(port_bench, capsys, monkeypatch):
    """``main --device cpu``: the device work in a child, one JSON line,
    one ledger line, the baseline from the port's own U-Net."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the child's, beside the other test workers
    assert port_bench.main(TINY) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "preflight", "card", "seconds",
                "eager_seconds", "pairs_per_s", "baseline_source"):
        assert key in rec, key
    assert rec["value"] > 0 and rec["vs_baseline"] > 0 and len(rec["seconds"]) == 1
    assert rec["preflight"]["status"] == "skipped" and rec["card"] is None
    assert rec["baseline_source"].startswith("port DiffusionUNet")
    assert rec["use_pallas"] is True  # the port's one tail: the CFG combine in the kernel
    lines = open(port_bench.LEDGER).read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["value"] == rec["value"]
    assert json.loads(lines[0])["use_pallas"] is True
    assert json.load(open(port_bench.CACHE))["ref_traj_per_sec_cpu"] > 0


def test_main_without_a_card_is_the_stale_exit(port_bench, capsys):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a GPU")
    port_bench._ledger_append({"ts": time.time(), "value": 640.5, "preflight": {"status": "ok"}})
    with pytest.raises(SystemExit) as exc:
        port_bench.main([])
    assert exc.value.code == 3
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["stale"] is True and rec["value"] == 640.5


_STUB_REFERENCE = """
import os

import torch


class DiffusionUNet(torch.nn.Module):
    def __init__(self, config, size_factor=1.0):
        super().__init__()
        self.conv = torch.nn.Conv2d(config.channels, config.channels, 3, padding=1)
        self.log = os.path.join(os.path.dirname(__file__), "calls.txt")

    def forward(self, x, t, c):
        with open(self.log, "a") as f:
            f.write(",".join(map(str, x.shape)) + "\\n")
        return self.conv(x)
"""


@pytest.mark.parametrize("stub", [True, False], ids=["reference", "broken-reference"])
def test_baseline_times_the_reference_unet_where_it_imports(port_bench, tmp_path, monkeypatch,
                                                             capsys, stub):
    """``DTT_REFERENCE_DIR`` names a directory whose ``models`` package has
    the reference's ``DiffusionUNet(config, size_factor)``, called on NCHW
    inputs: the baseline times it (2 warm-up + 5 x 3 forwards) and says so;
    without such a package the port's U-Net stands in, on record.  Either
    way the directory leaves ``sys.path`` and its modules ``sys.modules``."""
    ref = tmp_path / "reference"
    (ref / "models").mkdir(parents=True)
    if stub:
        (ref / "models" / "__init__.py").write_text(_STUB_REFERENCE)
    monkeypatch.setenv("DTT_REFERENCE_DIR", str(ref))
    path = list(sys.path)
    traj_per_s, source = port_bench.bench_reference_cpu(port_bench.parse_args(TINY))
    assert sys.path == path and "models" not in sys.modules
    assert traj_per_s > 0 and json.load(open(port_bench.CACHE))["source"] == source
    if stub:
        assert source == f"reference U-Net ({ref}), float32, host CPU, batch 2"
        assert (ref / "models" / "calls.txt").read_text().splitlines() == ["2,3,16,16"] * 17
    else:
        assert source.startswith("port DiffusionUNet")
        assert "reference U-Net import failed" in capsys.readouterr().err


@pytest.mark.parametrize("module", [bench_r2, bench_quant, bench_progressive, bench_fast],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_benches_raise_without_a_card(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--base_dir", str(tmp_path)])


class _TwoLevel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.enc = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.mid = torch.nn.Conv2d(8, 8, 3, padding=1)
        self.dec = torch.nn.Conv2d(16, 4, 1)
        self.head = torch.nn.Linear(4, 4)  # not a convolution: not counted

    def forward(self, x):
        a = self.enc(x)
        b = self.mid(torch.nn.functional.max_pool2d(a, 2))
        up = torch.nn.functional.interpolate(b, scale_factor=2)
        return self.head(self.dec(torch.cat([up, a], 1)).mean((2, 3)))


def test_conv_flops_is_the_hand_count():
    """2 x multiply-adds: output elements x (input channels x kernel area)."""
    x = torch.randn(2, 3, 8, 8)
    enc = 2 * (2 * 8 * 8 * 8) * (3 * 9)
    mid = 2 * (2 * 8 * 4 * 4) * (8 * 9)
    dec = 2 * (2 * 4 * 8 * 8) * 16
    assert conv_flops(_TwoLevel(), x) == enc + mid + dec == 108_544
