"""The port's five analysis CLIs of this slice and the orchestrator, against
the JAX CLIs on the CPU at a tiny size (16x16x1, T=6), on checkpoints the
port's trainers wrote (teacher sf 1.0, students {0.1, 0.2}) loaded into both
packages, with JAX's draws injected into the port:

- ``analyze_trajectories``: the averaged chains at rtol 2e-5 / atol 1e-5;
- ``analyze_effectiveness``: cosine and Euclid within rtol 1e-4, the
  synthetic fallback exact and taken only when the teacher cannot be read;
- ``analyze_dimensionality``: the chains at rtol 2e-5 / atol 1e-5, PCA by
  sign-invariant quantities within 1e-4, UMAP exact on the same chains;
- ``analyze_time_dependent``: the stored chains at rtol 2e-5 / atol 1e-5,
  their distances within rtol 1e-5 of JAX's on the same chains, batch
  metrics within rtol 1e-4 (atol 1e-6);
- each CLI's output file names equal the JAX CLI's, the port's PNGs over
  1 KB (rendered at 30 dpi; JAX's plot functions run with ``Figure.savefig``
  writing empty files and no layout: only their names are compared);
- the manager CLIs keep the JAX CLIs' ``teacher_steps`` behaviour;
- without ``--device cpu`` every CLI raises (no GPU here);
- ``scripts/run_analysis.py``: ``--skip`` dispatch, and one real run.
JAX CLI functions without a library counterpart are imported by file
path; their ``main`` is never run."""

import importlib.util
import os
import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.analysis import dimensionality as jax_dim
from distillation_trajectories_tpu.analysis import latent_space as jax_latent
from distillation_trajectories_tpu.analysis import visualization as jax_viz
from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion.sampling import CFG_COND_PAIRS, NOCFG_COND_PAIRS
from distillation_trajectories_tpu.metrics import time_dependent as jax_td
from distillation_trajectories_tpu.trajectories import TrajectoryManager as JaxManager
from distillation_trajectories_tpu.trajectories import (
    make_sweep_trajectory_fn as jax_make_sweep_trajectory_fn,
)
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.trajectories import TrajectoryManager
from distillation_trajectories_torch.scripts import (
    analyze_dimensionality,
    analyze_effectiveness,
    analyze_noise_prediction,
    analyze_time_dependent,
    analyze_trajectories,
    run_analysis,
)
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    KW,
    NAMES_ONLY,
    file_set,
    jax_chain_draws,
    jax_checkpoint_models,
    quick_plots,
    tmp_path,
    train_small,
)

torch.set_num_threads(2)

T = 6
SHAPE = (16, 16, 1)
TRAJ_TOL = dict(rtol=2e-5, atol=1e-5)
FLAGS = ["--dataset", "MNIST", "--image_size", "16", "--num_channels", "1"]
JAX_CLI_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "scripts", "analysis")


def _jax_cli(name):
    """A JAX analysis CLI module, imported by file path (its ``main`` is
    not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}",
                                                  os.path.join(JAX_CLI_DIR, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _quick_plots():
    with quick_plots():
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("trained")
    jcfg, _ = train_small(root)
    yield str(root), jax_checkpoint_models(jcfg)
    shutil.rmtree(root, ignore_errors=True)


def _port_config(root, **kw):
    """The float32 parity config of the port's CLIs over ``root``'s
    checkpoints (the CLIs' own make_config keeps the bf16 default)."""
    return Config(**{**KW, "device": "cpu", "base_dir": root, **kw}).create_directories()


def _flags(root, *extra):
    return FLAGS + ["--base_dir", root, "--device", "cpu", *extra]


def _pngs_over_1kb(root):
    names = [n for n in file_set(root) if n.endswith(".png")]
    assert names and all(os.path.getsize(os.path.join(root, n)) > 1000 for n in names)


def test_trajectories_cli_matches_jax(trained, tmp_path):
    root, jax_models = trained
    args = analyze_trajectories.parse_args(_flags(
        root, "--size_factor", "0.1", "--guidance_scales", "1.0,3.0", "--timesteps", str(T),
        "--num_samples", "2", "--output_dir", str(tmp_path / "port")))
    seeds = np.array([42, 43])
    draws = jax_chain_draws(seeds, T, SHAPE)
    got_t, got_s = analyze_trajectories.run(args, _port_config(root, timesteps=T), draws)

    jcfg = JaxConfig(**{**KW, "base_dir": root, "timesteps": T})
    noises = draws.noises.numpy()
    want = {}
    for role, sf in (("teacher", 1.0), ("student", 0.1)):
        fn = jax_make_sweep_trajectory_fn(*jax_models[sf], T, jcfg)
        want[role] = {gs: np.asarray(fn(noises, seeds, CFG_COND_PAIRS if gs > 1.0 else
                                        NOCFG_COND_PAIRS, np.float32(gs))).mean(axis=0)
                      for gs in (1.0, 3.0)}
    for role, got in (("teacher", got_t), ("student", got_s)):
        assert sorted(got) == [1.0, 3.0]
        for gs, w in want[role].items():
            assert got[gs].shape == (T + 1, *SHAPE)
            np.testing.assert_allclose(got[gs], w, **TRAJ_TOL, err_msg=f"{role} gs={gs}")

    analyze_trajectories.plot_all(got_t, got_s, [1.0, 3.0], str(tmp_path / "port"), 0.1)
    jax_cli = _jax_cli("analyze_trajectories")
    out = str(tmp_path / "jax")
    os.makedirs(out)
    with NAMES_ONLY:
        for trajs, model_type in ((want["teacher"], "Teacher"), (want["student"], "Student")):
            jax_cli.visualize_trajectories_pca(trajs, [1.0, 3.0], out, 0.1, model_type)
            jax_cli.visualize_final_images(trajs, [1.0, 3.0], out, 0.1, model_type)
        jax_cli.visualize_trajectory_comparison(want["teacher"], want["student"], [1.0, 3.0],
                                                out, 0.1)
    assert file_set(tmp_path / "port") == file_set(out)
    assert len(file_set(out)) == 32
    _pngs_over_1kb(tmp_path / "port")


@pytest.mark.parametrize("cli", ["trajectories", "effectiveness"])
def test_cli_default_draws_are_the_sweeps(trained, tmp_path, cli):
    """Without injected draws each CLI draws the sweep's own U-Net draws
    (``_sweep_inputs``, no labels) from its seeds: its result equals the
    run handed those draws."""
    from distillation_trajectories_torch.trajectories.engine import _sweep_inputs

    root, _ = trained
    cfg = _port_config(root, timesteps=T)
    flags = ["--guidance_scales", "1.0,3.0", "--timesteps", str(T), "--num_samples", "2",
             "--output_dir", str(tmp_path)]
    if cli == "trajectories":
        args = analyze_trajectories.parse_args(_flags(root, "--size_factor", "0.1", *flags))
        run, base_seed = analyze_trajectories.run, args.seed
    else:
        args = analyze_effectiveness.parse_args(_flags(root, "--size_factors", "0.1", *flags))
        run, base_seed = analyze_effectiveness.run, 0
    want = run(args, cfg, _sweep_inputs(cfg, 2, base_seed, T, None, "cpu"))
    np.testing.assert_equal(run(args, cfg), want)


def test_effectiveness_cli_matches_jax(trained, tmp_path):
    root, _ = trained
    args = analyze_effectiveness.parse_args(_flags(
        root, "--size_factors", "0.1,0.2,0.5", "--guidance_scales", "1.0,3.0",
        "--num_samples", "2", "--timesteps", str(T), "--output_dir", str(tmp_path / "port")))
    draws = jax_chain_draws(range(2), T, SHAPE)
    cosine, euclid, source = analyze_effectiveness.run(args, _port_config(root, timesteps=T),
                                                       draws)
    jax_cli = _jax_cli("analyze_effectiveness")
    want_cos, want_euc = jax_cli.compute_real_metrics(
        JaxConfig(**{**KW, "base_dir": root, "timesteps": T}), [0.1, 0.2, 0.5], [1.0, 3.0],
        2, None)
    assert source == "real" and sorted(cosine) == sorted(want_cos) == [0.1, 0.2]
    for got, want in ((cosine, want_cos), (euclid, want_euc)):
        for sf in want:
            np.testing.assert_allclose(got[sf], want[sf], rtol=1e-4, err_msg=str(sf))
    assert all(-1.0 <= c <= 1.0 for row in cosine.values() for c in row)

    analyze_effectiveness.create_consolidated_cfg_graph(str(tmp_path / "port"), [0.1, 0.2, 0.5],
                                                        [1.0, 3.0], cosine, euclid)
    with NAMES_ONLY:
        jax_cli.create_consolidated_cfg_graph(str(tmp_path / "jax"), [0.1, 0.2, 0.5],
                                              [1.0, 3.0], want_cos, want_euc)
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax") == {
        "consolidated_cfg_metrics.png", "cfg_effectiveness_ratio.png"}
    _pngs_over_1kb(tmp_path / "port")
    assert analyze_effectiveness.POSTER_COLORS == jax_cli.POSTER_COLORS


def test_effectiveness_falls_back_only_without_a_teacher(trained, tmp_path):
    root, _ = trained
    jax_cli = _jax_cli("analyze_effectiveness")
    sizes, scales = [0.1, 0.4, 1.0], [1.0, 2.0, 7.0]
    assert analyze_effectiveness.synthetic_metrics(sizes, scales) == jax_cli.synthetic_metrics(
        sizes, scales)
    empty = str(tmp_path / "empty")
    cosine, euclid, source = analyze_effectiveness.main(_flags(
        empty, "--size_factors", "0.1,0.4,1.0", "--guidance_scales", "1.0,2.0,7.0"))
    assert source == "synthetic" and (cosine, euclid) == jax_cli.synthetic_metrics(sizes, scales)
    assert file_set(os.path.join(empty, "analysis", "effectiveness")) == {
        "consolidated_cfg_metrics.png", "cfg_effectiveness_ratio.png"}

    args = analyze_effectiveness.parse_args(_flags(root, "--size_factors", "0.1",
                                                   "--timesteps", str(T)))
    cfg = _port_config(root, timesteps=T)
    for error, falls_back in ((OSError("unreadable"), True),
                              (RuntimeError("CUDA error: an illegal memory access"), False)):
        with mock.patch.object(analyze_effectiveness, "load_teacher_from_arg",
                               side_effect=error):
            if falls_back:
                assert analyze_effectiveness.run(args, cfg)[2] == "synthetic"
            else:
                with pytest.raises(RuntimeError, match="CUDA error"):
                    analyze_effectiveness.run(args, cfg)


def test_dimensionality_cli_matches_jax(trained, tmp_path):
    root, jax_models = trained
    args = analyze_dimensionality.parse_args(_flags(
        root, "--size_factors", "0.1,0.5", "--num_samples", "2", "--timesteps", "50"))
    # The chains run on teacher_steps = T, whatever --timesteps says.
    cfg = _port_config(root, timesteps=T)
    draws = jax_chain_draws(range(2), T, SHAPE)
    out = analyze_dimensionality.run(args, cfg, draws)
    assert sorted(out) == [0.1]

    jcfg = JaxConfig(**{**KW, "base_dir": str(tmp_path / "jax"), "timesteps": T})
    jcfg.create_directories()
    manager = JaxManager(jax_models[1.0][0], jax_models[0.1][0], jcfg, size_factor=0.1,
                         teacher_variables=jax_models[1.0][1],
                         student_variables=jax_models[0.1][1])
    want_pairs = [manager.generate_trajectory(seed=i) for i in range(2)]
    for (gt, gs), (wt, ws) in zip(out[0.1]["pairs"], want_pairs):
        assert gt.shape == (T + 1, *SHAPE)
        np.testing.assert_allclose(gt, wt, **TRAJ_TOL)
        np.testing.assert_allclose(gs, ws, **TRAJ_TOL)

    # PCA from chains of two frameworks: sign-invariant quantities.
    for entry, (wt, ws) in zip(out[0.1]["embeddings"], want_pairs):
        combined = np.vstack([wt.reshape(T + 1, -1), ws.reshape(T + 1, -1)])
        emb, ratio, _, _ = jax_dim.pca_fit_transform(combined, 2)
        scale = float(np.abs(emb).max())
        np.testing.assert_allclose(entry["pca_ratio"], ratio, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.abs(entry["pca"]), np.abs(emb), rtol=0, atol=1e-4 * scale)
        dist = lambda e: np.linalg.norm(e[:, None] - e[None], axis=-1)
        np.testing.assert_allclose(dist(entry["pca"]), dist(emb), rtol=0, atol=1e-4 * scale)
    latent = out[0.1]["latent"]
    emb, ratio, _, _ = jax_dim.pca_fit_transform(np.vstack(
        [want_pairs[0][0].reshape(T + 1, -1), want_pairs[0][1].reshape(T + 1, -1)]), 3)
    np.testing.assert_allclose(latent["ratio"], ratio, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.abs(np.vstack([latent["teacher"], latent["student"]])),
                               np.abs(emb), rtol=0, atol=1e-4 * float(np.abs(emb).max()))
    # UMAP on the same chains: exact.
    gt, gs = out[0.1]["pairs"][0]
    np.testing.assert_array_equal(
        out[0.1]["embeddings"][0]["umap"],
        jax_dim.umap_fallback_embedding(np.vstack([gt.reshape(T + 1, -1), gs.reshape(T + 1, -1)]),
                                        n_neighbors=4, min_dist=0.1, random_state=42))

    analyze_dimensionality.plot(out, cfg)
    with NAMES_ONLY:
        jax_dim.dimensionality_reduction_analysis([p[0] for p in want_pairs],
                                                  [p[1] for p in want_pairs], jcfg,
                                                  size_factor=0.1)
        jax_latent.generate_latent_space_visualization(want_pairs[0][0], want_pairs[0][1],
                                                       jcfg, size_factor=0.1)
    for sub in ("dimensionality", "latent_space"):
        got = file_set(os.path.join(cfg.analysis_dir, sub))
        assert got == file_set(os.path.join(jcfg.analysis_dir, sub)), sub
        _pngs_over_1kb(os.path.join(cfg.analysis_dir, sub))
    assert len(file_set(os.path.join(cfg.analysis_dir, "dimensionality"))) == 6


def test_time_dependent_cli_matches_jax(trained, tmp_path):
    root, jax_models = trained
    args = analyze_time_dependent.parse_args(_flags(
        root, "--size_factors", "0.1,0.2,0.5", "--num_samples", "3", "--timesteps", "50"))
    cfg = _port_config(root, timesteps=T)
    distances, all_metrics = analyze_time_dependent.run(
        args, cfg, jax_chain_draws(range(3), T, SHAPE))
    assert sorted(distances) == sorted(all_metrics) == [0.1, 0.2]
    assert len(os.listdir(cfg.trajectory_dir)) == 6  # 3 npz files per size

    jcfg = JaxConfig(**{**KW, "base_dir": str(tmp_path / "jax"), "timesteps": T})
    jcfg.create_directories()
    want_distances, want_metrics = {}, {}
    with NAMES_ONLY:
        for sf in (0.1, 0.2):
            manager = JaxManager(jax_models[1.0][0], jax_models[sf][0], jcfg, size_factor=sf,
                                 teacher_variables=jax_models[1.0][1],
                                 student_variables=jax_models[sf][1])
            manager.generate_and_save_trajectories(num_samples=3)
            pairs = manager.load_trajectories()
            want_distances[sf] = jax_td.analyze_time_dependent_distances(
                [p[0] for p in pairs], [p[1] for p in pairs], jcfg, size_factor=sf,
                save_dir=jcfg.time_dependent_dir)
            want_metrics[sf] = manager.compute_trajectory_metrics_batch()
        jax_viz.plot_time_dependent_grid(want_distances, jcfg)
        jax_viz.plot_time_dependent_combined(want_distances, jcfg)
        jax_viz.plot_trajectory_divergence_vs_timestep(want_metrics, jcfg)
        jax_viz.generate_3d_model_size_visualization(want_metrics, jcfg)

    for sf in (0.1, 0.2):
        # The stored chains at the sampler tolerance; the distances at rtol
        # 1e-5 against JAX's distances of the same stored chains (the
        # chains' own 1e-5 differences move a step distance by ~1e-5).
        stored = TrajectoryManager(None, None, cfg, size_factor=sf, device="cpu").load_trajectories()
        jax_stored = JaxManager(None, None, jcfg, size_factor=sf).load_trajectories()
        assert len(stored) == len(jax_stored) == 3
        for (gt, gs), (wt, ws) in zip(stored, jax_stored):
            np.testing.assert_allclose(gt, wt, **TRAJ_TOL)
            np.testing.assert_allclose(gs, ws, **TRAJ_TOL)
        want = jax_td.analyze_time_dependent_distances(
            [p[0] for p in stored], [p[1] for p in stored], jcfg, size_factor=sf)
        assert set(distances[sf]) == set(want_distances[sf]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(np.asarray(distances[sf][k]), np.asarray(w),
                                       rtol=1e-5, err_msg=f"{sf} {k}")
        assert set(all_metrics[sf]) == set(want_metrics[sf])
        for k, w in want_metrics[sf].items():
            np.testing.assert_allclose(np.asarray(all_metrics[sf][k], dtype=np.float64),
                                       np.asarray(w, dtype=np.float64), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{sf} {k}")

    analyze_time_dependent.plot(distances, all_metrics, cfg)
    for sub in ("time_dependent", "model_size_3d"):
        got = file_set(os.path.join(cfg.analysis_dir, sub))
        assert got == file_set(os.path.join(jcfg.analysis_dir, sub)) and got, sub
        _pngs_over_1kb(os.path.join(cfg.analysis_dir, sub))


def test_noise_prediction_cli_run_writes_the_text(trained, tmp_path):
    root, _ = trained
    args = analyze_noise_prediction.parse_args(_flags(root, "--size_factors", "0.1,0.2,0.5"))
    cfg = _port_config(root)
    out = analyze_noise_prediction.run(args, cfg)
    assert sorted(out) == [0.1, 0.2]
    for sf, (results, samples) in out.items():
        assert all(np.isfinite(m["mse"]) and -1.0 <= m["cosine_similarity"] <= 1.0
                   for m in results["metrics_by_timestep"].values())
        assert samples["teacher_pred"].shape == (10, *SHAPE)
        folder = os.path.join(cfg.analysis_dir, "noise_prediction", f"size_{sf}")
        assert os.listdir(folder) == [f"noise_metrics_size_{sf}.txt"]


def test_manager_clis_keep_the_jax_teacher_steps(trained):
    """The JAX CLIs set ``config.timesteps`` after the Config is built, so
    the manager's chains keep ``teacher_steps`` = 100."""
    root, _ = trained
    jax_config = JaxConfig()
    jax_config.timesteps = 10
    assert jax_config.teacher_steps == 100
    for cli in (analyze_dimensionality, analyze_time_dependent):
        cfg = cli.make_config(cli.parse_args(_flags(root, "--timesteps", "10")))
        assert (cfg.timesteps, cfg.teacher_steps, cfg.student_steps) == (10, 100, 100)
    cfg = analyze_trajectories.make_config(analyze_trajectories.parse_args(_flags(root)))
    assert (cfg.timesteps, cfg.device) == (50, "cpu")


@pytest.mark.parametrize("cli", [analyze_trajectories, analyze_effectiveness,
                                 analyze_dimensionality, analyze_noise_prediction,
                                 analyze_time_dependent])
def test_default_device_is_cuda(trained, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run there")
    root, _ = trained
    for base in (root, str(tmp_path)):  # with checkpoints, and without any
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(FLAGS + ["--base_dir", base])


def test_run_analysis_dispatch(capsys):
    calls = []

    def fake_run(cmd, env):
        assert run_analysis._ROOT in env["PYTHONPATH"].split(os.pathsep)
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 3 if cmd[2].endswith("analyze_fid") else 0)

    with mock.patch.object(run_analysis.subprocess, "run", fake_run):
        codes = run_analysis.main(["--skip", "analyze_trajectories, analyze_effectiveness",
                                   "--teacher_model", "model_epoch_2.msgpack",
                                   "--base_dir", "/data/run", "--device", "cpu"])
    ran = [name for name in run_analysis.SCRIPTS
           if name not in ("analyze_trajectories", "analyze_effectiveness")]
    assert [c[2] for c in calls] == [f"distillation_trajectories_torch.scripts.{n}" for n in ran]
    assert all(c[1] == "-m" and c[3:] == ["--teacher_model", "model_epoch_2.msgpack",
                                          "--base_dir", "/data/run", "--device", "cpu"]
               for c in calls)
    assert codes == {n: (3 if n == "analyze_fid" else 0) for n in ran}
    out = capsys.readouterr().out
    assert "Skipping analyze_trajectories" in out and "Skipping analyze_effectiveness" in out
    assert "Warning: analyze_fid exited with code 3" in out
    assert out.rstrip().endswith("Analysis pipeline complete")


def test_run_analysis_runs_a_cli(trained, monkeypatch):
    """A relative ``--base_dir`` resolves against the caller's directory."""
    root, _ = trained
    monkeypatch.chdir(os.path.dirname(root))
    skip = ",".join(n for n in run_analysis.SCRIPTS if n != "analyze_noise_prediction")
    codes = run_analysis.main(["--skip", skip, "--base_dir", os.path.basename(root),
                               "--device", "cpu", *FLAGS])
    assert codes == {"analyze_noise_prediction": 0}
    folder = os.path.join(root, "output", "analysis", "noise_prediction", "size_0.1")
    assert file_set(folder) == {"noise_metrics_size_0.1.txt", "noise_predictions_size_0.1.png",
                                "noise_metrics_by_timestep_size_0.1.png"}
    _pngs_over_1kb(folder)
