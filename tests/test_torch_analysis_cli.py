"""The port's analysis CLIs end to end on the CPU at a tiny size, on
checkpoints the port's trainers wrote: the CFG-sweep CLI with two
``--jobs`` (the JAX CLI's file names, the ``[jobs]`` lines the full-sweep
runner parses) and the FID CLI (summary files with the feature provenance,
per-size score files and grids).  Without ``--device cpu`` both default to
``cuda`` and raise on a machine without a GPU."""

import json
import os

import numpy as np
import pytest
import torch

from distillation_trajectories_torch.scripts import analyze_fid, analyze_trajectory_metrics
from distillation_trajectories_torch.training import train_students, train_teacher
from torch_parity import configs

torch.set_num_threads(2)

FLAGS = ["--dataset", "MNIST", "--image_size", "16", "--num_channels", "1"]


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    """A teacher and students {0.1, 0.2}, one epoch of one batch each."""
    root = tmp_path_factory.mktemp("trained")
    _, cfg = configs(root, limit_batches_per_epoch=1, num_samples_to_generate=0)
    train_teacher(cfg, seed=0)
    train_students(cfg, custom_size_factors=[0.1, 0.2], seed=0)
    return str(root)


def test_cfg_sweep_cli_writes_the_jax_artifacts(base_dir, capsys):
    jobs = json.dumps([
        {"output_dir": "analysis/heatmaps", "size_factors": "0.1,0.2"},
        {"size_factors": "0.1,0.5,0.9", "timesteps": 5, "guidance_scales": "3.0",
         "output_dir": "analysis/trio"},
    ])
    results = analyze_trajectory_metrics.main(
        FLAGS + ["--base_dir", base_dir, "--timesteps", "8", "--num_samples", "2",
                 "--guidance_scales", "1.0,3.0", "--jobs", jobs, "--device", "cpu"])
    assert [sorted(r) for r in results] == [[0.1, 0.2], [0.1]]
    for metrics in results:
        for per_role in metrics.values():
            for per_gs in per_role["student_metrics"].values():
                assert np.isfinite(per_gs["path_length_similarity"])
    out = capsys.readouterr().out
    assert "[jobs] job 0 (heatmaps): marginal" in out and "[jobs] job 1 (trio): marginal" in out
    for name, scales in (("heatmaps", ("1.0", "3.0")), ("trio", ("3.0",))):
        files = set(os.listdir(os.path.join(base_dir, "analysis", name)))
        want = {f"cfg_heatmap_{k}.png" for k, _ in analyze_trajectory_metrics.METRICS_TO_ANALYZE}
        want |= {"cfg_heatmap_combined.png"}
        want |= {f"{kind}_gs_{gs}.png" for gs in scales
                 for kind in ("radar_plots", "composite_radar_plot")}
        assert files == want, name


def test_fid_cli_writes_summary_with_provenance(base_dir):
    fid_by_size = analyze_fid.main(
        FLAGS + ["--base_dir", base_dir, "--timesteps", "8", "--num_samples", "3",
                 "--size_factors", "0.1,0.2,0.5", "--device", "cpu"])
    assert sorted(fid_by_size) == [0.1, 0.2]
    fid_dir = os.path.join(base_dir, "output", "analysis", "fid")
    with open(os.path.join(fid_dir, "fid_summary.json")) as f:
        record = json.load(f)
    assert record["features"] == "seeded-random"
    assert record["imagenet_fid_comparable"] is False
    assert record["num_samples"] == 3 and set(record["fid_by_size"]) == {"0.1", "0.2"}
    assert all(np.isfinite(v) and v >= 0 for v in record["fid_by_size"].values())
    with open(os.path.join(fid_dir, "fid_summary.txt")) as f:
        text = f.read()
    assert text.startswith("features: seeded-random") and "size_0.2:" in text
    assert os.path.getsize(os.path.join(fid_dir, "fid_vs_size.png")) > 1000
    for sf in (0.1, 0.2):
        assert sorted(os.listdir(os.path.join(fid_dir, f"size_{sf}"))) == [
            f"fid_samples_size_{sf}.png", f"fid_score_size_{sf}.txt"]


@pytest.mark.parametrize("cli, extra", [
    (analyze_trajectory_metrics, ["--size_factors", "0.1", "--guidance_scales", "1.0"]),
    (analyze_fid, ["--size_factors", "0.1"]),
], ids=["cfg-sweep", "fid"])
def test_default_device_is_cuda(base_dir, cli, extra):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run there")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(FLAGS + ["--base_dir", base_dir] + extra)


def test_mesh_raises(base_dir):
    with pytest.raises(NotImplementedError):
        analyze_trajectory_metrics.main(FLAGS + ["--base_dir", base_dir, "--mesh", "2,1",
                                                 "--device", "cpu"])
