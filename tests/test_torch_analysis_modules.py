"""Port parity for the analysis modules: the numpy copies (PCA, the UMAP
fallback, the local ᾱ formula) exact on identical inputs; the align-corners
resize within 1e-6; time-dependent distances within rtol 1e-5; the noise
prediction per-timestep metrics within rtol 1e-4 (atol 1e-6) with JAX's
noise injected; the denoising comparison's trajectories at the sampler
tolerance (rtol 2e-5 / atol 1e-5); the metric reports' summary dicts and
text equal to JAX's; every plot function's file names equal to JAX's.

Models are checkpoints that the port's trainers wrote (teacher sf 1.0,
students {0.1, 0.2}, 16x16x1, one batch each), loaded into both packages.
The port's PNGs are rendered at 30 dpi; JAX's plot functions run with
``Figure.savefig`` replaced by an empty-file writer and no layout: only
their file names are compared."""

import os
import shutil
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import distillation_trajectories_tpu.analysis as jax_analysis
import distillation_trajectories_tpu.metrics as jax_metrics
from distillation_trajectories_tpu.analysis import dimensionality as jax_dim
from distillation_trajectories_tpu.analysis import latent_space as jax_latent
from distillation_trajectories_tpu.analysis import noise_prediction as jax_noise
from distillation_trajectories_tpu.analysis import visualization as jax_viz
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_diffusion_params
from distillation_trajectories_tpu.diffusion.sampling import (
    generate_trajectory_scan as jax_generate_trajectory_scan,
)
from distillation_trajectories_tpu.metrics import size_dependent as jax_size
from distillation_trajectories_tpu.metrics import time_dependent as jax_td
from distillation_trajectories_tpu.metrics import visualize as jax_visualize
from distillation_trajectories_tpu.models.unet import (
    resize_bilinear_align_corners as jax_resize,
)
from distillation_trajectories_tpu.training.state import make_eval_model_fn as jax_eval_fn
import distillation_trajectories_torch.analysis as analysis
import distillation_trajectories_torch.metrics as metrics
from distillation_trajectories_torch.analysis import dimensionality, latent_space, noise_prediction
from distillation_trajectories_torch.analysis import visualization
from distillation_trajectories_torch.metrics import size_dependent, time_dependent, visualize
from distillation_trajectories_torch.models import resize_bilinear_align_corners
from distillation_trajectories_torch.scripts._common import load_student, load_teacher_from_arg
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    NAMES_ONLY,
    configs,
    file_set,
    jax_checkpoint_models,
    jax_noises,
    jax_step_noise,
    quick_plots,
    tmp_path,
    train_small,
)

torch.set_num_threads(2)

TRAJ_TOL = dict(rtol=2e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _quick_plots():
    with quick_plots():
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' configs and models on the port trainers' checkpoints."""
    root = tmp_path_factory.mktemp("trained")
    jcfg, tcfg = train_small(root)
    port = {1.0: load_teacher_from_arg(tcfg)}
    port.update({sf: load_student(tcfg, sf) for sf in (0.1, 0.2)})
    yield jcfg, tcfg, jax_checkpoint_models(jcfg), port
    shutil.rmtree(root, ignore_errors=True)


# -- numpy copies ------------------------------------------------------------


@pytest.mark.parametrize("n_components", [2, 3])
def test_pca_fit_transform_is_exact(n_components):
    data = np.random.default_rng(0).normal(size=(30, 50))
    for got, want in zip(dimensionality.pca_fit_transform(data, n_components),
                         jax_dim.pca_fit_transform(data, n_components)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [24, 7])
def test_umap_fallback_is_exact(n):
    data = np.random.default_rng(1).normal(size=(n, 40))
    k = min(15, max(n // 3, 2))
    np.testing.assert_array_equal(
        dimensionality.umap_fallback_embedding(data, n_neighbors=k),
        jax_dim.umap_fallback_embedding(data, n_neighbors=k))


@pytest.mark.parametrize("timesteps", [10, 100])
def test_local_alpha_bars_is_exact(timesteps):
    jcfg, tcfg = configs(timesteps=timesteps)
    got = noise_prediction.local_alpha_bars(tcfg)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jax_noise.local_alpha_bars(jcfg))


@pytest.mark.parametrize("shape, size", [
    ((2, 16, 16, 1), (8, 8)),
    ((2, 8, 8, 3), (16, 16)),
    ((1, 5, 7, 2), (9, 4)),
    ((1, 1, 1, 1), (3, 3)),
    ((2, 4, 4, 1), (1, 1)),
])
def test_resize_bilinear_align_corners_matches_jax(shape, size):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got = resize_bilinear_align_corners(torch.from_numpy(x), size)
    want = np.asarray(jax_resize(x, size))
    assert got.shape == want.shape == (shape[0], *size, shape[3])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- time-dependent distances --------------------------------------------------


def _trajectory_lists(form):
    rng = np.random.default_rng(3)
    trajs = [np.cumsum(rng.normal(size=(n, 8, 8, 1)), axis=0).astype(np.float32)
             for n in (9, 8, 9)]
    if form == "tuples":
        return [[(state, t) for t, state in enumerate(traj)] for traj in trajs]
    if form == "lists":
        return [list(traj) for traj in trajs]
    return trajs


@pytest.mark.parametrize("form", ["arrays", "lists", "tuples"])
def test_time_dependent_distances_match_jax(form, tmp_path):
    jcfg, tcfg = configs()
    teacher = _trajectory_lists(form)
    student = [traj[::-1] for traj in _trajectory_lists(form)]
    save = form == "arrays"
    got = time_dependent.analyze_time_dependent_distances(
        teacher, student, tcfg, size_factor=0.5,
        save_dir=str(tmp_path / "port") if save else None)
    with NAMES_ONLY:
        want = jax_td.analyze_time_dependent_distances(
            teacher, student, jcfg, size_factor=0.5,
            save_dir=str(tmp_path / "jax") if save else None)
    assert set(got) == set(want) and got["size_factor"] == 0.5
    for k, w in want.items():
        if k != "size_factor":
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), rtol=1e-5, err_msg=k)
    assert len(got["teacher_distances"]) == 3 and len(got["teacher_avg_per_timestep"]) == 7
    if save:
        assert file_set(tmp_path / "port") == file_set(tmp_path / "jax") == {
            "time_dependent_distances_size_0.5.png"}
        assert os.path.getsize(tmp_path / "port" / "time_dependent_distances_size_0.5.png") > 1000


def test_time_dependent_distances_of_nothing_match_jax():
    jcfg, tcfg = configs()
    assert (time_dependent.analyze_time_dependent_distances([], None, tcfg, size_factor=0.1)
            == jax_td.analyze_time_dependent_distances([], None, jcfg, size_factor=0.1))


# -- noise prediction ----------------------------------------------------------


def _jax_noise_draws(seed, n_timesteps, shape):
    """``analyze_noise_prediction``'s per-timestep noise: the split chain
    off ``PRNGKey(seed)``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_timesteps):
        key, nk = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(nk, shape)))
    return np.stack(out)


def _text_lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def test_noise_prediction_matches_jax(trained, tmp_path):
    jcfg, tcfg, jax_models, port = trained
    (jt, tv), (js, sv) = jax_models[1.0], jax_models[0.1]
    with NAMES_ONLY:
        want = jax_noise.analyze_noise_prediction(
            jt, js, jcfg, output_dir=str(tmp_path / "jax"), size_factor=0.1,
            teacher_variables=tv, student_variables=sv)
    noise = _jax_noise_draws(0, 10, (10, 16, 16, 1))
    got = noise_prediction.analyze_noise_prediction(
        port[1.0], port[0.1], tcfg, output_dir=str(tmp_path / "port"), size_factor=0.1,
        noise=noise)
    assert set(got) == set(want)
    assert sorted(got["metrics_by_timestep"]) == sorted(want["metrics_by_timestep"]) == [
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
    for t, w in want["metrics_by_timestep"].items():
        for k in ("mse", "mae", "cosine_similarity"):
            np.testing.assert_allclose(got["metrics_by_timestep"][t][k], w[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"t={t} {k}")
    for k in ("avg_mse", "avg_mae", "avg_cosine_similarity"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax") == {
        "noise_metrics_size_0.1.txt", "noise_predictions_size_0.1.png",
        "noise_metrics_by_timestep_size_0.1.png"}
    for name in ("noise_predictions_size_0.1.png", "noise_metrics_by_timestep_size_0.1.png"):
        assert os.path.getsize(tmp_path / "port" / name) > 1000
    # The same text: the labels equal, the numbers at the tolerance above.
    got_lines = _text_lines(tmp_path / "port" / "noise_metrics_size_0.1.txt")
    want_lines = _text_lines(tmp_path / "jax" / "noise_metrics_size_0.1.txt")
    assert len(got_lines) == len(want_lines) == 45
    for g, w in zip(got_lines, want_lines):
        g_label, _, g_num = g.rpartition(": ")
        w_label, _, w_num = w.rpartition(": ")
        assert g_label == w_label
        if w_label:  # printed with 6 decimals: atol 2e-6 covers the rounding
            np.testing.assert_allclose(float(g_num), float(w_num), rtol=1e-4, atol=2e-6)
        else:
            assert g == w


def test_noise_prediction_default_draw_and_shape_check(trained):
    _, tcfg, _, port = trained
    images = np.random.default_rng(4).uniform(-1, 1, (3, 16, 16, 1)).astype(np.float32)
    first, samples = noise_prediction.noise_prediction_metrics(
        port[1.0], port[0.2], tcfg, images=images, n_timesteps=4, seed=5)
    again, _ = noise_prediction.noise_prediction_metrics(
        port[1.0], port[0.2], tcfg, images=images, n_timesteps=4, seed=5)
    assert first == again and sorted(first["metrics_by_timestep"]) == [0, 3, 6, 9]
    assert samples["noisy"].shape == samples["teacher_pred"].shape == (3, 16, 16, 1)
    with pytest.raises(ValueError, match="noise has shape"):
        noise_prediction.noise_prediction_metrics(port[1.0], port[0.2], tcfg, images=images,
                                                  n_timesteps=4, noise=np.zeros((3, 3, 16, 16, 1)))


def test_calculate_noise_metrics_resizes_like_jax():
    rng = np.random.default_rng(5)
    teacher = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    student = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    got = noise_prediction.calculate_noise_metrics(torch.from_numpy(teacher),
                                                   torch.from_numpy(student))
    want = jax_noise.calculate_noise_metrics(teacher, student)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=k)


# -- denoising comparison ------------------------------------------------------


def test_denoising_comparison_matches_jax(trained):
    jcfg, tcfg, jax_models, port = trained
    shape = (16, 16, 1)
    noise = jax_noises([0], shape)
    step_noise = jax_step_noise([0], tcfg.timesteps, shape)
    got = visualization.denoising_trajectories(
        port, tcfg, seed=0, noise=torch.from_numpy(noise),
        step_noise=torch.from_numpy(step_noise))
    assert sorted(got) == [0.1, 0.2, 1.0]
    alphas = jax_diffusion_params(jcfg.timesteps, jcfg)["alphas"]
    for sf, (model, variables) in jax_models.items():
        want = jax_generate_trajectory_scan(jax_eval_fn(model, variables), noise,
                                            jcfg.timesteps, alphas, 0)
        assert got[sf].shape == (jcfg.timesteps + 1, *shape)
        np.testing.assert_allclose(got[sf], np.asarray(want)[:, 0], **TRAJ_TOL, err_msg=str(sf))
    path = visualization.plot_denoising_comparison(got, tcfg.denoising_dir)
    assert path == os.path.join(tcfg.denoising_dir, "denoising_comparison.png")
    assert os.path.getsize(path) > 1000


def test_denoising_default_noise_is_the_seeds(trained):
    _, tcfg, _, port = trained
    small = {sf: port[sf] for sf in (0.1, 0.2)}
    a = visualization.denoising_trajectories(small, tcfg, seed=3)
    b = visualization.denoising_trajectories({0.1: port[0.1]}, tcfg, seed=3)
    np.testing.assert_array_equal(a[0.1], b[0.1])
    assert not np.array_equal(a[0.1], visualization.denoising_trajectories(
        {0.1: port[0.1]}, tcfg, seed=4)[0.1])


# -- reports and plots ---------------------------------------------------------


def _batch_metrics(full):
    rng = np.random.default_rng(6)
    out = {
        "wasserstein_distances": list(rng.uniform(0, 1, 6)),
        "endpoint_distances": list(rng.uniform(1, 2, 6)),
        "teacher_path_lengths": list(rng.uniform(3, 4, 6)),
        "student_path_lengths": list(rng.uniform(3, 5, 6)),
        "wasserstein_distances_per_timestep": rng.uniform(0, 1, (6, 11)).tolist(),
        "mean_velocity_similarity": 0.7,
        "distribution_similarity_avg": 0.9,
    }
    if full:
        out.update({
            "teacher_efficiency": list(rng.uniform(0, 1, 6)),
            "student_efficiency": list(rng.uniform(0, 1, 6)),
            "path_length_similarity_avg": 0.8,
            "mean_directional_consistency_avg": 0.6,
            "mean_position_difference": 0.3,
        })
    return out


@pytest.mark.parametrize("full, size_factor", [(True, 0.5), (False, None)])
def test_visualize_batch_metrics_matches_jax(full, size_factor, tmp_path):
    jcfg, tcfg = configs(tmp_path)
    batch = _batch_metrics(full)
    with NAMES_ONLY:
        got = visualize.visualize_batch_metrics(batch, tcfg, size_factor, str(tmp_path / "port"))
        want = jax_visualize.visualize_batch_metrics(batch, jcfg, size_factor,
                                                     str(tmp_path / "jax"))
    assert got == want
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax")
    name = f"summary_size_{size_factor}.txt" if size_factor else "summary.txt"
    assert _text_lines(tmp_path / "port" / name) == _text_lines(tmp_path / "jax" / name)


def test_visualize_metrics_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    m = {k: float(rng.uniform()) for k in (
        "teacher_path_length", "student_path_length", "path_length_similarity",
        "endpoint_distance", "mean_velocity_similarity", "teacher_efficiency",
        "student_efficiency", "efficiency_similarity", "mean_wasserstein",
        "distribution_similarity", "mean_directional_consistency",
        "mean_position_difference", "path_length_ratio")}
    m.update({k: list(rng.uniform(size=9)) for k in (
        "teacher_velocities", "student_velocities", "teacher_accelerations",
        "student_accelerations", "wasserstein_distances", "directional_consistency",
        "position_differences")})
    with NAMES_ONLY:
        visualize.visualize_metrics(m, str(tmp_path / "port"), size_factor=0.2, suffix="_x")
        jax_visualize.visualize_metrics(m, str(tmp_path / "jax"), size_factor=0.2, suffix="_x")
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax")
    assert len(file_set(tmp_path / "port")) == 9
    assert _text_lines(tmp_path / "port" / "summary_x.txt") == _text_lines(
        tmp_path / "jax" / "summary_x.txt")


def test_size_dependent_plots_match_jax(tmp_path):
    jcfg, tcfg = configs(tmp_path)
    by_size = {"size_0.1": {"mse": 0.3, "mean_wasserstein": 0.2, "path_length_ratio": 1.1},
               "size_0.5": {"mean_wasserstein": 0.1, "efficiency_ratio": 0.9},
               0.2: {}, "size_x": {}, "other": {"mse": 1.0}}
    for port_fn, jax_fn in ((size_dependent.plot_mse_vs_size, jax_size.plot_mse_vs_size),
                            (size_dependent.plot_metrics_vs_size, jax_size.plot_metrics_vs_size)):
        with NAMES_ONLY:
            port_fn(by_size, tcfg, str(tmp_path / "port"))
            jax_fn(by_size, jcfg, str(tmp_path / "jax"))
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax") == {
        "mse_vs_size.png", "metrics_vs_size.png"}


def _cross_size_inputs(n_sizes):
    rng = np.random.default_rng(8)
    sizes = [0.1, 0.5, 0.2][:n_sizes]
    distances = {sf: {"teacher_avg_per_timestep": list(rng.uniform(1, 2, 10)),
                      "student_avg_per_timestep": list(rng.uniform(0, 2, 10))} for sf in sizes}
    distances[0.9] = {"teacher_avg_per_timestep": [], "student_avg_per_timestep": [1.0]}
    all_metrics = {sf: {"wasserstein_distances_per_timestep": rng.uniform(0, 1, (3, 11)).tolist()}
                   for sf in sizes}
    return distances, all_metrics


@pytest.mark.parametrize("n_sizes", [3, 1, 0])
def test_cross_size_plots_match_jax(n_sizes, tmp_path):
    jcfg, tcfg = configs(tmp_path / "port_cfg")
    jcfg.analysis_dir = str(tmp_path / "jax_cfg")
    distances, all_metrics = _cross_size_inputs(n_sizes)
    results = {}
    with NAMES_ONLY:
        for name, mod, cfg in (("port", visualization, tcfg), ("jax", jax_viz, jcfg)):
            out = str(tmp_path / name)
            mod.plot_time_dependent_grid(distances, cfg, save_dir=out)
            mod.plot_time_dependent_combined(distances, cfg, save_dir=out)
            mod.plot_trajectory_divergence_vs_timestep(all_metrics, cfg, save_dir=out)
            results[name] = mod.generate_3d_model_size_visualization(all_metrics, cfg)
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax")
    got, want = results["port"], results["jax"]
    assert got["status"] == want["status"] == ("ok" if n_sizes >= 2 else "skipped")
    if n_sizes >= 2:
        assert os.path.basename(got["path"]) == os.path.basename(want["path"])
        assert got["path"] == os.path.join(tcfg.analysis_dir, "model_size_3d",
                                           "model_size_3d_surface.png")
    else:
        assert got == want


def _pair_lists(n_pairs, n_steps, dim, seed):
    rng = np.random.default_rng(seed)
    teacher = [np.cumsum(rng.normal(size=(n_steps, dim, 1, 1)), axis=0) for _ in range(n_pairs)]
    student = [t + rng.normal(0, 0.1, t.shape) for t in teacher]
    return teacher, student


def test_dimensionality_and_latent_space_match_jax(tmp_path):
    jcfg, tcfg = configs(tmp_path / "port")
    jcfg.dimensionality_dir = str(tmp_path / "jax" / "dimensionality")
    jcfg.latent_space_dir = str(tmp_path / "jax" / "latent_space")
    teacher, student = _pair_lists(4, 9, 12, 9)
    embeddings = dimensionality.dimensionality_embeddings(teacher, student)
    assert len(embeddings) == 3  # at most 3 trajectories, as in JAX
    for entry, t, s in zip(embeddings, teacher, student):
        combined = np.vstack([t.reshape(9, -1), s.reshape(9, -1)])
        emb, ratio, _, _ = jax_dim.pca_fit_transform(combined, 2)
        np.testing.assert_array_equal(entry["pca"], emb)
        np.testing.assert_array_equal(entry["pca_ratio"], ratio)
        np.testing.assert_array_equal(entry["umap"], jax_dim.umap_fallback_embedding(
            combined, n_neighbors=6, min_dist=0.1, random_state=42))
        assert entry["umap_method"] == "numpy fallback" and entry["n_teacher"] == 9
        from sklearn.manifold import TSNE

        np.testing.assert_allclose(entry["tsne"], TSNE(n_components=2, perplexity=3,
                                                       random_state=42).fit_transform(combined))
    pca = latent_space.latent_space_pca(teacher, student)
    emb, ratio, _, _ = jax_dim.pca_fit_transform(
        np.vstack([teacher[0].reshape(9, -1), student[0].reshape(9, -1)]), 3)
    np.testing.assert_array_equal(np.vstack([pca["teacher"], pca["student"]]), emb)
    np.testing.assert_array_equal(pca["ratio"], ratio)

    with NAMES_ONLY:
        got_dir = dimensionality.dimensionality_reduction_analysis(teacher, student, tcfg,
                                                                   size_factor=0.1)
        jax_dim.dimensionality_reduction_analysis(teacher, student, jcfg, size_factor=0.1)
        latent_space.generate_latent_space_visualization(teacher[0], student[0], tcfg, 0.1)
        jax_latent.generate_latent_space_visualization(teacher[0], student[0], jcfg, 0.1)
    assert got_dir == os.path.join(tcfg.dimensionality_dir, "size_0.1")
    for sub in ("dimensionality", "latent_space"):
        got = file_set(os.path.join(tcfg.analysis_dir, sub))
        assert got == file_set(tmp_path / "jax" / sub) and got, sub
    assert len(file_set(os.path.join(tcfg.analysis_dir, "dimensionality"))) == 9


def _names_only_embedding_plot(*args):
    open(args[-1], "wb").close()


def test_dimensionality_skips_tsne_like_jax(tmp_path, capsys):
    jcfg, tcfg = configs(tmp_path)
    teacher, student = _pair_lists(1, 251, 3, 10)  # 502 points: above t-SNE's 500
    big = dimensionality.dimensionality_embeddings(teacher, student)
    capsys.readouterr()
    with mock.patch.object(jax_dim, "_plot_embedding", _names_only_embedding_plot):
        jax_dim.dimensionality_reduction_analysis(teacher, student, jcfg, size_factor=0.3)
    assert big[0]["tsne"] is None
    assert big[0]["tsne_skipped"] == "Skipping t-SNE for trajectory 0 (too many points)"
    assert f"  {big[0]['tsne_skipped']}\n" in capsys.readouterr().out
    teacher, student = _pair_lists(1, 5, 3, 11)
    capsys.readouterr()
    with mock.patch.dict(sys.modules, {"sklearn": None, "sklearn.manifold": None}):
        entry = dimensionality.dimensionality_embeddings(teacher, student)[0]
        port_out = capsys.readouterr().out
        with NAMES_ONLY:
            jax_dim.dimensionality_reduction_analysis(teacher, student, jcfg, size_factor=0.4)
        jax_out = capsys.readouterr().out
    assert entry["tsne"] is None and entry["tsne_skipped"].startswith("Error performing t-SNE: ")
    assert f"  {entry['tsne_skipped']}\n" in port_out and f"  {entry['tsne_skipped']}\n" in jax_out
    assert not os.path.exists(os.path.join(jcfg.dimensionality_dir, "size_0.4", "trajectory_0",
                                           "tsne_trajectory.png"))


def test_exports_match_jax():
    public = lambda mod: {k for k, v in vars(mod).items()
                          if callable(v) and not k.startswith("_")}
    assert public(jax_analysis) == public(analysis)
    for name in ("visualize_metrics", "visualize_batch_metrics",
                 "analyze_time_dependent_distances", "plot_mse_vs_size", "plot_metrics_vs_size"):
        assert callable(getattr(metrics, name)) and callable(getattr(jax_metrics, name))
