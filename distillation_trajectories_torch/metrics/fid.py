"""FID: Inception features on the device, Fréchet math on the host (port
of ``metrics/fid.py``).

* :class:`InceptionModel` — the InceptionV3 trunk (``models/inception.py``)
  in float32 on the device, fed in batches of 32.
* :func:`calculate_fid` — the Fréchet distance in numpy/scipy float64: the
  exact low-rank SVD cross-term when both sample counts are below the
  feature dimension, the dense ``sqrtm`` otherwise, the complex-part
  guard, and 999.0 for fewer than two samples.
* :func:`fid_across_sizes` — samples the teacher once and every student
  with ``p_sample_loop``, extracts features, fetches everything to the
  host in one transfer, and writes each size's ``fid_score_size_{sf}.txt``
  and ``fid_samples_size_{sf}.png`` (teacher row over student row, the
  JAX package's matplotlib figure; the raw grid where matplotlib does not
  import).

Draws: the teacher's sample set comes from one seeded stream and every
student's from one second stream shared by all students, as the JAX
package splits its key into ``k1`` and ``k2``.  A stream is a
``(noise, step_noise)`` pair (``[N, H, W, C]`` and ``[n_steps, N, H, W,
C]``), injectable so that tests can hand in the JAX draws.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import linalg

from ..config import resolve_device
from ..diffusion.sampling import _generator_seed, p_sample_loop, subsampled_timestep_indices
from ..diffusion.schedules import get_diffusion_params
from ..models.inception import create_inception, preprocess_for_inception
from ..training.state import make_eval_model_fn
from ..utils.viz import image_grid, save_figure

FEATURE_DIM = 2048
Draw = Tuple[torch.Tensor, torch.Tensor]


class InceptionModel:
    """Batched feature extraction with the InceptionV3 trunk in float32 on
    ``device`` (default ``cuda``)."""

    def __init__(self, weights_path: Optional[str] = None, batch_size: int = 32, device=None):
        self.device = resolve_device("cuda" if device is None else device)
        self.model, self.pretrained = create_inception(weights_path, device=self.device)
        self.batch_size = batch_size

    def features_device(self, images) -> torch.Tensor:
        """``[N, H, W, C]`` in [−1, 1] → ``[N, 2048]`` features on the
        device (no host synchronisation)."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        with torch.no_grad():
            outs = [self.model(preprocess_for_inception(images[i:i + self.batch_size]))
                    for i in range(0, images.shape[0], self.batch_size)]
        return torch.cat(outs) if outs else torch.zeros((0, FEATURE_DIM), device=self.device)

    def get_features(self, images) -> np.ndarray:
        """``[N, H, W, C]`` in [−1, 1] → ``[N, 2048]`` features on the host."""
        return self.features_device(images).cpu().numpy()


def calculate_fid(features1: np.ndarray, features2: np.ndarray) -> float:
    """Fréchet distance between two feature sets.

    With ``max(n1, n2) < d`` the covariances have rank below ``d`` and the
    cross-term ``tr((Σ₁Σ₂)^{1/2})`` is exactly Σₖ σₖ(A₁A₂ᵀ)/√((n₁−1)(n₂−1))
    (Aᵢ the centred features as rows); otherwise the dense ``sqrtm``, with
    its imaginary part dropped.  Fewer than two samples give 999.0."""
    features1 = np.asarray(features1, dtype=np.float64)
    features2 = np.asarray(features2, dtype=np.float64)
    if len(features1) < 2 or len(features2) < 2:
        return 999.0

    n1, n2 = len(features1), len(features2)
    d = features1.shape[1]
    mu1, mu2 = features1.mean(axis=0), features2.mean(axis=0)
    diff = mu1 - mu2

    if max(n1, n2) < d:
        a1 = features1 - mu1
        a2 = features2 - mu2
        tr1 = float(np.sum(a1 * a1)) / (n1 - 1)
        tr2 = float(np.sum(a2 * a2)) / (n2 - 1)
        sv = linalg.svdvals(a1 @ a2.T)
        tr_cross = float(np.sum(sv)) / np.sqrt((n1 - 1) * (n2 - 1))
        return float(diff @ diff + tr1 + tr2 - 2.0 * tr_cross)

    sigma1 = np.cov(features1, rowvar=False)
    sigma2 = np.cov(features2, rowvar=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        covmean = linalg.sqrtm(sigma1 @ sigma2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def _n_steps(config) -> int:
    return len(subsampled_timestep_indices(config.sample_steps, config.timesteps))


def _shape(config, num_samples: int):
    return (num_samples, config.image_size, config.image_size, config.channels)


def default_draw(config, num_samples: int, seed: int, stream: int, device) -> Draw:
    """Stream ``stream`` (1: teacher, 2: students) of ``seed``: starting
    noise and per-step noise from one generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(_generator_seed(seed, stream))
    shape = _shape(config, num_samples)
    noise = torch.randn(shape, generator=gen, device=device)
    return noise, torch.randn((_n_steps(config), *shape), generator=gen, device=device)


def make_sample_fn(model, config, num_samples: int):
    """``fn(draw, params=None) -> samples [N, H, W, C]``: ``p_sample_loop``
    of ``model``'s architecture over ``config.sample_steps`` from a
    ``(noise, step_noise)`` draw; ``params`` (parameters and buffers by
    name) stand in for ``model``'s own, so one sampler serves every model
    of the architecture."""
    dp = get_diffusion_params(config.sample_steps, config)
    shape = _shape(config, num_samples)

    def sample(draw: Draw, params=None) -> torch.Tensor:
        noise, step_noise = draw
        return p_sample_loop(make_eval_model_fn(model, params), shape, config.sample_steps, dp,
                             noise=noise, step_noise=step_noise,
                             num_timesteps=config.timesteps)

    return sample


def generate_samples(model, config, num_samples: int, draw: Optional[Draw] = None,
                     seed: int = 0, fixed_samples=None, device=None) -> torch.Tensor:
    """``num_samples`` samples of ``model`` by ``p_sample_loop`` on
    ``device`` (default ``config.device``), from ``draw`` or the teacher
    stream of ``seed``; ``fixed_samples`` are returned as they are."""
    device = resolve_device(config.device if device is None else device)
    if fixed_samples is not None:
        return torch.as_tensor(np.asarray(fixed_samples[:num_samples]), dtype=torch.float32,
                               device=device)
    if draw is None:
        draw = default_draw(config, num_samples, seed, 1, device)
    return make_sample_fn(model, config, num_samples)(draw)


def _draw_comparison(figure_cls, teacher_samples, student_samples, n_show, size_factor,
                     path) -> None:
    """JAX ``_fid_report``'s figure: a 2 x ``n_show`` panel, teacher row over
    student row, titled, saved at 300 dpi (matplotlib's object API,
    ``figure_cls`` its ``Figure``, not pyplot)."""
    fig = figure_cls(figsize=(3 * n_show, 6))
    axes = fig.subplots(2, n_show, squeeze=False)
    fig.suptitle(f"Sample Comparison (Size Factor: {size_factor})", fontsize=16)
    for row, samples, label in ((0, teacher_samples, "Teacher"), (1, student_samples, "Student")):
        for i in range(n_show):
            img = np.clip((samples[i] + 1) / 2.0, 0, 1)
            if img.shape[-1] == 1:
                img = img[..., 0]
            axes[row, i].imshow(img, cmap="gray" if img.ndim == 2 else None)
            axes[row, i].set_title(label)
            axes[row, i].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=300)


def _write_artifacts(teacher_samples, student_samples, size_factor, output_dir,
                     fid_score: float) -> None:
    """``fid_samples_size_{sf}.png`` (up to five teacher samples over as
    many student samples, drawn as JAX draws them where matplotlib imports,
    else the raw grid: ``utils.viz.save_figure``) and
    ``fid_score_size_{sf}.txt``."""
    n_show = min(5, len(teacher_samples), len(student_samples))
    if n_show > 0:
        rows = [np.asarray(torch.as_tensor(s[:n_show]).float().cpu())
                for s in (teacher_samples, student_samples)]
        path = os.path.join(output_dir, f"fid_samples_size_{size_factor}.png")
        save_figure(lambda figure_cls: _draw_comparison(figure_cls, *rows, n_show,
                                                        size_factor, path),
                    image_grid(np.concatenate(rows), nrow=n_show), path)
    with open(os.path.join(output_dir, f"fid_score_size_{size_factor}.txt"), "w") as f:
        f.write(f"FID Score: {fid_score:.4f}\n")


def _fid_report(teacher_samples, student_samples, size_factor, output_dir,
                inception) -> Dict[str, float]:
    """Features → FID → sample grid and score file for one size factor."""
    print("  Extracting features using InceptionV3...")
    teacher_features = inception.get_features(teacher_samples)
    student_features = inception.get_features(student_samples)
    print("  Calculating FID score...")
    fid_score = calculate_fid(teacher_features, student_features)
    print(f"  FID score for size factor {size_factor}: {fid_score:.4f}")
    _write_artifacts(teacher_samples, student_samples, size_factor, output_dir, fid_score)
    return {"fid_score": fid_score}


def calculate_and_visualize_fid(teacher_model, student_model, config,
                                output_dir: Optional[str] = None,
                                size_factor: Optional[float] = None, fixed_samples=None,
                                inception: Optional[InceptionModel] = None,
                                num_samples: Optional[int] = None, seed: int = 0,
                                draws: Optional[Tuple[Draw, Draw]] = None,
                                device=None) -> Dict[str, float]:
    """FID between teacher and student samples, with the sample grid and
    the score file, for one size factor.  ``draws`` are the (teacher,
    student) streams; by default streams 1 and 2 of ``seed``."""
    device = resolve_device(config.device if device is None else device)
    if output_dir is None:
        output_dir = os.path.join(config.analysis_dir, "fid", f"size_{size_factor}")
    os.makedirs(output_dir, exist_ok=True)
    print(f"Calculating FID scores for size factor {size_factor}...")
    if num_samples is None:
        num_samples = getattr(config, "num_samples", 50)
    if draws is None:
        draws = tuple(default_draw(config, num_samples, seed, k, device) for k in (1, 2))
    print("  Generating samples from teacher model...")
    teacher_samples = generate_samples(teacher_model, config, num_samples, draws[0],
                                       fixed_samples=fixed_samples, device=device)
    print("  Generating samples from student model...")
    student_samples = generate_samples(student_model, config, num_samples, draws[1],
                                       fixed_samples=fixed_samples, device=device)
    if inception is None:
        inception = InceptionModel(device=device)
    return _fid_report(teacher_samples, student_samples, size_factor, output_dir, inception)


def _arch(model):
    return (tuple(model.dims), model.time_emb_dim)


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fid_across_sizes(teacher_model, students, config,
                     inception: Optional[InceptionModel] = None, num_samples: int = 50,
                     seed: int = 0, draws: Optional[Tuple[Draw, Draw]] = None,
                     device=None, timings: Optional[dict] = None) -> Dict[float, float]:
    """FID of every student (``{size_factor: model}``) against one teacher,
    with the per-size artifacts of :func:`calculate_and_visualize_fid` and
    the same scores: the teacher's samples and features are made once, one
    sampler serves each architecture, and one transfer brings every
    feature set and shown sample to the host.

    ``inception`` may be any object with ``get_features`` (host arrays in
    and out); with ``features_device`` the features stay on the device
    until the transfer.  ``timings``, when given, receives the seconds of
    sampling, feature extraction, the transfer, the Fréchet math and the
    artifacts, each apart.
    """
    if not students:
        return {}
    device = resolve_device(config.device if device is None else device)
    if inception is None:
        inception = InceptionModel(device=device)
    if draws is None:
        draws = tuple(default_draw(config, num_samples, seed, k, device) for k in (1, 2))
    draws = tuple((noise.to(device), step.to(device)) for noise, step in draws)

    samplers = {_arch(teacher_model): make_sample_fn(teacher_model, config, num_samples)}
    owners = {_arch(teacher_model): teacher_model}

    def sample(model, draw):
        arch = _arch(model)
        if arch not in samplers:
            samplers[arch] = make_sample_fn(model, config, num_samples)
            owners[arch] = model
        params = None if owners[arch] is model else {
            **dict(model.named_parameters()), **dict(model.named_buffers())}
        return samplers[arch](draw, params)

    t0 = time.perf_counter()
    teacher_samples = sample(teacher_model, draws[0])
    student_samples = {sf: sample(model, draws[1]) for sf, model in students.items()}
    _synchronize(device)
    t_sample = time.perf_counter() - t0

    t0 = time.perf_counter()
    featurize = getattr(inception, "features_device", None)
    if featurize is None:  # a host-only featurizer gets host arrays
        featurize = lambda s: inception.get_features(s.cpu().numpy())  # noqa: E731
    teacher_features = featurize(teacher_samples)
    student_features = {sf: featurize(s) for sf, s in student_samples.items()}
    _synchronize(device)
    t_features = time.perf_counter() - t0

    # One transfer for every device array the reports need.
    t0 = time.perf_counter()
    n_show = min(5, num_samples)
    arrays = [teacher_samples[:n_show], teacher_features]
    for sf in students:
        arrays += [student_samples[sf][:n_show], student_features[sf]]
    flat = torch.cat([a.reshape(-1).float() for a in arrays if torch.is_tensor(a)]).cpu()
    offset, host = 0, []
    for a in arrays:
        if torch.is_tensor(a):
            host.append(flat[offset:offset + a.numel()].reshape(a.shape).numpy())
            offset += a.numel()
        else:
            host.append(np.asarray(a))
    t_transfer = time.perf_counter() - t0

    t0 = time.perf_counter()
    fid_by_size = {sf: calculate_fid(host[1], host[3 + 2 * i]) for i, sf in enumerate(students)}
    t_frechet = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i, sf in enumerate(students):
        output_dir = os.path.join(config.analysis_dir, "fid", f"size_{sf}")
        os.makedirs(output_dir, exist_ok=True)
        print(f"  FID score for size factor {sf}: {fid_by_size[sf]:.4f}")
        _write_artifacts(host[0], host[2 + 2 * i], sf, output_dir, fid_by_size[sf])
    t_artifacts = time.perf_counter() - t0
    print(f"[fid] sampling {t_sample:.2f}s, features {t_features:.2f}s, transfer "
          f"{t_transfer:.2f}s, Fréchet {t_frechet:.3f}s, artifacts {t_artifacts:.2f}s "
          f"({len(students)} sizes, {num_samples} samples, {len(samplers)} samplers) "
          f"on {device}")
    if timings is not None:
        timings.update(sampling_s=t_sample, features_s=t_features, transfer_s=t_transfer,
                       frechet_s=t_frechet, artifacts_s=t_artifacts, samplers=len(samplers))
    return fid_by_size
