"""Port parity for the whole slice: the sweep engine vs the JAX sweep with
all three random draws injected from JAX, and JAX-written checkpoints
loading into the port."""

import copy
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.models import make_init_fn
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training.checkpoints import save_checkpoint
from distillation_trajectories_tpu.training.state import make_optimizer
from distillation_trajectories_tpu.trajectories import (
    sweep_compare_trajectories as jax_sweep_compare_trajectories,
)
from distillation_trajectories_tpu.trajectories.engine import (
    _sweep_inputs as jax_sweep_inputs,
)
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import load_unet_variables, make_unet
from distillation_trajectories_torch.training.checkpoints import (
    available_epochs,
    latest_epoch,
    load_checkpoint,
    variables_from_checkpoint,
)
from distillation_trajectories_torch.trajectories import (
    SweepDraws,
    compare_trajectories,
    generate_trajectory,
    sweep_compare_trajectories,
    sweep_compare_trajectories_multi,
)
from torch_parity import tmp_path  # noqa: F401  (each test's outputs removed when it ends)

torch.set_num_threads(2)

KW = dict(dataset="MNIST", image_size=16, channels=1, batch_size=8,
          sample_steps=10, timesteps=10, epochs=1, compute_dtype="float32")


def _jax_models(cfg):
    """tests/test_trajectories.py::_models: teacher sf 0.2, student sf 0.1."""
    teacher = jax_make_unet(cfg, size_factor=0.2)
    student = jax_make_unet(cfg, size_factor=0.1)
    init = lambda m, k: make_init_fn(m, cfg, force_jit=True)(jax.random.PRNGKey(k))
    return teacher, init(teacher, 0), student, init(student, 1)


def _port_model(cfg, size_factor, variables):
    model = make_unet(cfg, size_factor=size_factor, device="cpu")
    return load_unet_variables(model, jax.tree_util.tree_map(np.asarray, variables))


def _jax_draws(cfg, num_samples, base_seed):
    """The JAX sweep's three draws: starting noises, per-step noise and
    the per-sample Wasserstein subsample uniforms."""
    noises, seeds, _ = jax_sweep_inputs(cfg, num_samples, base_seed)
    shape = (cfg.image_size, cfg.image_size, cfg.channels)
    step_noise = np.stack([
        np.stack([
            np.asarray(jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(int(s)), t), shape))
            for s in np.asarray(seeds)
        ])
        for t in range(cfg.timesteps - 1, 0, -1)
    ])
    keys = jax.random.split(jax.random.PRNGKey(base_seed), num_samples)
    uniforms = np.stack([
        np.asarray(jax.random.uniform(k, (cfg.timesteps + 1, int(np.prod(shape)))))
        for k in keys
    ])
    return SweepDraws(*(torch.from_numpy(np.array(a)) for a in (noises, step_noise, uniforms)))


def test_sweep_matches_jax_sweep(tmp_path):
    jcfg = JaxConfig(base_dir=str(tmp_path), **KW)
    tcfg = Config(base_dir=str(tmp_path), device="cpu", **KW)
    teacher, t_vars, student, s_vars = _jax_models(jcfg)
    want = jax_sweep_compare_trajectories(
        teacher, t_vars, {0.1: (student, s_vars)}, jcfg,
        guidance_scales=(1.0, 3.0), num_samples=2, base_seed=42, verbose=False,
    )
    got = sweep_compare_trajectories(
        _port_model(tcfg, 0.2, t_vars), {0.1: _port_model(tcfg, 0.1, s_vars)}, tcfg,
        guidance_scales=(1.0, 3.0), num_samples=2, base_seed=42,
        draws=_jax_draws(jcfg, 2, 42), verbose=False,
    )
    assert set(got) == {0.1}
    assert set(got[0.1]) == {"teacher_metrics", "student_metrics"}
    for role in ("teacher_metrics", "student_metrics"):
        assert set(got[0.1][role]) == {1.0, 3.0}
        for gs in (1.0, 3.0):
            g, w = got[0.1][role][gs], want[0.1][role][gs]
            assert set(g) == set(w)
            for k in w:
                assert isinstance(g[k], float), k
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                           err_msg=f"{role} gs={gs} {k}")
    # Same values under both keys, in independent dicts.
    assert got[0.1]["teacher_metrics"][3.0] is not got[0.1]["student_metrics"][3.0]
    assert got[0.1]["teacher_metrics"][1.0]["endpoint_distance"] != (
        got[0.1]["teacher_metrics"][3.0]["endpoint_distance"])


def test_checkpoint_written_by_jax_loads_with_same_forward(tmp_path):
    jcfg = JaxConfig(base_dir=str(tmp_path), **KW)
    tcfg = Config(base_dir=str(tmp_path), device="cpu", **KW)
    jmodel = jax_make_unet(jcfg, size_factor=0.1)
    variables = make_init_fn(jmodel, jcfg, force_jit=True)(jax.random.PRNGKey(4))
    params = variables["params"]
    ema = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    directory = str(tmp_path / "ckpt")
    save_checkpoint(directory, 1, params, variables["batch_stats"])
    save_checkpoint(directory, 3, params, variables["batch_stats"],
                    opt_state=make_optimizer(jcfg).init(params), ema_params=ema,
                    extra={"note": "x"})
    assert available_epochs(directory) == [1, 3] and latest_epoch(directory) == 3

    payload = load_checkpoint(directory)
    assert payload["epoch"] == 3 and payload["extra"] == {"note": "x"}
    leaf = payload["ema_params"]["enc1"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        leaf, np.asarray(ema["enc1"]["conv1"]["kernel"], dtype=np.float32))

    model = make_unet(tcfg, size_factor=0.1, device="cpu")
    load_unet_variables(model, variables_from_checkpoint(payload)).eval()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([2.0, 7.0], np.float32)
    cond = np.array([[0.0], [1.0]], np.float32)
    apply = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))
    want = np.asarray(apply(variables, x, t, cond, np.ones_like(cond)))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, t, cond, np.ones_like(cond))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_generate_trajectory_and_compare_contract():
    tcfg = Config(device="cpu", **KW)
    teacher = make_unet(tcfg, size_factor=0.2, device="cpu", seed=0)
    student = make_unet(tcfg, size_factor=0.1, device="cpu", seed=1)
    noise = torch.randn((1, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    traj = generate_trajectory(teacher, noise, 10, seed=3, config=tcfg)
    assert traj.shape == (11, 1, 16, 16, 1)
    assert torch.equal(traj[-1], traj[-2])
    out = compare_trajectories(teacher, student, tcfg, guidance_scales=[1.0, 3.0],
                               size_factor=0.1, num_samples=2)
    assert set(out) == {"teacher_metrics", "student_metrics"}
    for gs in (1.0, 3.0):
        for k in ("endpoint_distance", "path_length_similarity",
                  "mean_directional_consistency", "mean_wasserstein"):
            assert np.isfinite(out["teacher_metrics"][gs][k]), k


@pytest.mark.parametrize(
    "override",
    [dict(mesh_shape=(2, 1)), dict(spatial_shape=(1, 2)),
     dict(mesh_shape=(1, 2)), dict(spatial_shape=(2, 1))],
)
def test_unported_options_raise(override):
    """The multi-device options in a process without their ranks: JAX's
    ``ValueError`` (the mesh needs 2 devices) from the sweep, and from
    ``generate_trajectory`` under ``spatial_shape``; under ``mesh_shape``
    that sampler runs unsharded, as JAX's ignores the mesh.  The lanes
    themselves are held in tests/test_torch_{sharded_sweep,spatial}.py."""
    tcfg = dataclasses.replace(Config(device="cpu", **KW), **override)
    model = make_unet(tcfg, size_factor=0.1, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices.*torchrun --nproc_per_node=2"):
        sweep_compare_trajectories(model, {0.1: model}, tcfg, num_samples=1)
    noise = torch.randn((1, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    if "spatial_shape" in override:
        with pytest.raises(ValueError, match="needs 2 devices"):
            generate_trajectory(model, noise, 10, config=tcfg)
    else:
        plain = dataclasses.replace(tcfg, mesh_shape=(1, 1))
        torch.testing.assert_close(generate_trajectory(model, noise, 10, config=tcfg),
                                   generate_trajectory(model, noise, 10, config=plain),
                                   rtol=0, atol=0)


def test_multi_job_sweep_takes_jobs_of_unequal_sample_counts():
    """Jobs of 2 and 3 samples in one ``sweep_compare_trajectories_multi``
    call: each job's metrics are those of the job swept alone (the one host
    transfer at the end splits the vectors by length)."""
    tcfg = Config(device="cpu", **{**KW, "timesteps": 4})
    model = make_unet(tcfg, size_factor=0.1, device="cpu")
    jobs = [{"students": {0.1: model}, "num_samples": n, "base_seed": seed,
             "guidance_scales": (1.0, 3.0), "timesteps": 4} for n, seed in ((2, 5), (3, 9))]
    together = sweep_compare_trajectories_multi(model, jobs, tcfg, verbose=False)
    for job, got in zip(jobs, together):
        assert got == sweep_compare_trajectories_multi(model, [job], tcfg, verbose=False)[0]


# -- the sweep's resident makers ---------------------------------------------


def _resident_models(cfg):
    teacher = make_unet(cfg, size_factor=0.2, device="cpu", seed=0)
    return teacher, {0.1: make_unet(cfg, size_factor=0.1, device="cpu", seed=1),
                     0.2: make_unet(cfg, size_factor=0.2, device="cpu", seed=2)}


def _spied_sweep(monkeypatch):
    """``(sweep(teacher, students, cfg, **job) -> (results, sweep.makers
    attrs), built, paths)``: ``built`` lists the model (its first parameter)
    of each maker made, ``paths`` each chain run as ``(first parameter,
    "eager" or "maker", CFG on)``."""
    from distillation_trajectories_torch.trajectories import engine
    from distillation_trajectories_torch.utils.profiling import recording

    made = engine.make_sweep_trajectory_fn
    built, paths = [], []

    def spy(model, timesteps, config):
        fn, first = made(model, timesteps, config), next(model.parameters())

        def run(noises, seeds, cond_pairs, gs, step_noise=None, eager=False):
            paths.append((first, "eager" if eager else "maker",
                          bool(np.asarray(cond_pairs)[1, 0])))
            return fn(noises, seeds, cond_pairs, gs, step_noise=step_noise, eager=eager)

        run.graphs = fn.graphs
        built.append(first)
        return run

    monkeypatch.setattr(engine, "make_sweep_trajectory_fn", spy)

    def sweep(teacher, students, cfg, jobs=None, **job):
        job = {"students": students, "guidance_scales": (1.0, 3.0, 5.0), "num_samples": 2,
               "base_seed": 5, "timesteps": cfg.timesteps, **job}
        with recording() as rec:
            out = sweep_compare_trajectories_multi(teacher, jobs or [job], cfg, device="cpu",
                                                   verbose=False)
        (makers,) = [s.attrs for s in rec.spans if s.name == "sweep.makers"]
        return out, makers

    return sweep, built, paths


def test_second_sweep_call_replays_resident_makers(monkeypatch):
    """A second call with the same models, T and config builds no maker
    (``built`` 0, ``reused`` 3) and returns the first call's results at the
    same ``base_seed``."""
    cfg = Config(device="cpu", **{**KW, "timesteps": 4})
    teacher, students = _resident_models(cfg)
    sweep, built, _ = _spied_sweep(monkeypatch)
    first, makers = sweep(teacher, students, cfg)
    assert len(built) == 3 and makers == {"built": 3, "reused": 0}
    second, makers = sweep(teacher, students, cfg)
    assert len(built) == 3 and makers == {"built": 0, "reused": 3}
    assert second == first
    assert sweep(teacher, students, cfg, base_seed=6)[0] != first


def _replace_storage(models):
    p = next(models["student"].parameters())
    p.data = p.data.clone()


def _change_in_place(models):
    with torch.no_grad():
        next(models["student"].parameters()).mul_(1.01)


@pytest.mark.parametrize("change, rebuilt", [
    (_replace_storage, {"student"}),
    (_change_in_place, {"student"}),
    (lambda models: models["cfg"].update(timesteps=3), {"teacher", "student", "other"}),
    (lambda models: models["cfg"].update(trajectory_store_dtype="bfloat16"),
     {"teacher", "student", "other"}),
    (lambda models: models["cfg"].update(sampler_quant="int8"), {"teacher", "student", "other"}),
], ids=["storage", "in_place", "timesteps", "store_dtype", "int8"])
def test_sweep_rebuilds_exactly_the_affected_makers(monkeypatch, change, rebuilt):
    """A parameter given other storage or changed in place rebuilds that
    model's maker alone; another T, store dtype or ``sampler_quant``
    rebuilds every maker of the call.  Each result equals a call on fresh
    copies of the models (makers built anew)."""
    cfg = Config(device="cpu", **{**KW, "timesteps": 4})
    teacher, students = _resident_models(cfg)
    models = {"teacher": teacher, "student": students[0.1], "other": students[0.2], "cfg": {}}
    sweep, built, _ = _spied_sweep(monkeypatch)
    sweep(teacher, students, cfg)
    built.clear()
    change(models)
    cfg = dataclasses.replace(cfg, **models["cfg"])
    got, makers = sweep(teacher, students, cfg, timesteps=cfg.timesteps)
    firsts = {name: next(models[name].parameters()) for name in ("teacher", "student", "other")}
    assert {name for name, p in firsts.items() if any(p is b for b in built)} == rebuilt
    assert makers["built"] == len(built) == len(rebuilt)
    assert makers["reused"] == 3 - len(rebuilt)
    fresh = {sf: copy.deepcopy(m) for sf, m in students.items()}
    assert got == sweep(copy.deepcopy(teacher), fresh, cfg, timesteps=cfg.timesteps)[0]


def test_int8_sweep_refolds_weights_changed_in_place(monkeypatch):
    """Under ``sampler_quant="int8"`` the maker folds the weights when it is
    built, so every call builds its makers and the store keeps none: after
    an in-place change the next call folds them again, and its results
    equal those of fresh copies of the models."""
    from distillation_trajectories_torch.trajectories import engine

    cfg = Config(device="cpu", **{**KW, "timesteps": 4, "sampler_quant": "int8"})
    teacher, students = _resident_models(cfg)
    sweep, built, _ = _spied_sweep(monkeypatch)
    before = sweep(teacher, students, cfg)[0]
    assert sweep(teacher, students, cfg)[0] == before and len(built) == 6
    assert all(engine._RESIDENT[m] == {} for m in (teacher, *students.values()))
    with torch.no_grad():
        for p in teacher.parameters():
            p.mul_(1.05)
    after, makers = sweep(teacher, students, cfg)
    assert makers == {"built": 3, "reused": 0} and after != before
    fresh = {sf: copy.deepcopy(m) for sf, m in students.items()}
    assert after == sweep(copy.deepcopy(teacher), fresh, cfg)[0]


def test_int8_sweep_runs_its_cfg_off_chains_eagerly(monkeypatch):
    """The int8 makers, built every call and kept by none, run each model's
    CFG chains through the maker and its CFG-off chain eagerly, in every
    call; the results equal those of a call whose chains all run through
    the maker."""
    from distillation_trajectories_torch.trajectories import engine

    cfg = Config(device="cpu", **{**KW, "timesteps": 4, "sampler_quant": "int8"})
    teacher, students = _resident_models(cfg)
    sweep, _, paths = _spied_sweep(monkeypatch)
    for _ in range(2):
        paths.clear()
        got = sweep(teacher, students, cfg)[0]
        assert sorted((path, cfg_on) for _, path, cfg_on in paths) == (
            [("eager", False)] * 3 + [("maker", True)] * 6)
    made = engine._resident_makers

    def kept(*a, **k):
        makers, built = made(*a, **k)
        for entry in makers.values():
            entry.kept = True
        return makers, built

    monkeypatch.setattr(engine, "_resident_makers", kept)
    paths.clear()
    assert sweep(teacher, students, cfg)[0] == got
    assert {path for _, path, _ in paths} == {"maker"}


@pytest.mark.parametrize("quant, built", [("none", 0), ("int8", 3)])
def test_sweep_sees_weights_changed_without_a_version(monkeypatch, quant, built):
    """A write that raises no ``_version`` (through ``.data`` here; on the
    card, a CUDA-graph replay of a training step) leaves the stamp as it
    was: the plain makers stay resident and read the new weights in place,
    the int8 ones are built anew as every call.  Either way the results
    equal those of fresh copies of the models."""
    cfg = Config(device="cpu", **{**KW, "timesteps": 4, "sampler_quant": quant})
    teacher, students = _resident_models(cfg)
    sweep, _, _ = _spied_sweep(monkeypatch)
    before = sweep(teacher, students, cfg)[0]
    versions = [p._version for p in teacher.parameters()]
    for p in teacher.parameters():
        p.data.mul_(1.05)
    assert [p._version for p in teacher.parameters()] == versions
    after, makers = sweep(teacher, students, cfg)
    assert makers["built"] == built and after != before
    fresh = {sf: copy.deepcopy(m) for sf, m in students.items()}
    assert after == sweep(copy.deepcopy(teacher), fresh, cfg)[0]


def test_collected_model_leaves_no_resident_maker(monkeypatch):
    """The store keeps no model alive: once its models are deleted and
    collected, their makers are gone too."""
    from distillation_trajectories_torch.trajectories import engine

    cfg = Config(device="cpu", **{**KW, "timesteps": 4})
    teacher, students = _resident_models(cfg)
    sweep, _, _ = _spied_sweep(monkeypatch)
    sweep(teacher, students, cfg)
    refs = [weakref.ref(m) for m in (teacher, *students.values())]
    makers = [weakref.ref(e.fn) for m in (teacher, *students.values())
              for e in engine._RESIDENT[m].values()]
    assert len(makers) == 3
    del teacher, students
    gc.collect()
    assert all(r() is None for r in refs + makers)
    assert not any(r() in engine._RESIDENT for r in refs)


def test_every_sweep_chain_goes_through_its_maker(monkeypatch):
    """Two jobs on the same draws share the teacher's chains: every chain,
    the CFG-off chain that runs once a call included, goes through its
    model's maker (captured on the card), never the eager body, in a first
    call, in a call of CFG-off chains alone that runs the teacher's twice,
    and in a call that runs each chain once."""
    cfg = Config(device="cpu", **{**KW, "timesteps": 4})
    teacher, students = _resident_models(cfg)
    sweep, _, paths = _spied_sweep(monkeypatch)
    jobs = [{"students": {sf: m}, "guidance_scales": (1.0, 3.0, 5.0), "num_samples": 2,
             "base_seed": 5, "timesteps": 4} for sf, m in students.items()]
    _, makers = sweep(teacher, None, cfg, jobs=jobs)
    assert makers == {"built": 3, "reused": 0}
    assert sorted({(path, cfg_on) for _, path, cfg_on in paths}) == [
        ("maker", False), ("maker", True)]
    assert len(paths) == 3 * 3  # three scales of three models: the teacher's serve both jobs
    paths.clear()
    twice = [dict(job, guidance_scales=(1.0,), base_seed=seed)
             for job, seed in zip(jobs, (7, 8))]
    _, makers = sweep(teacher, None, cfg, jobs=twice)  # CFG off: the teacher's runs twice
    assert makers == {"built": 0, "reused": 3}
    teacher_first = next(teacher.parameters())
    assert sorted((p is teacher_first, path) for p, path, _ in paths) == [
        (False, "maker"), (False, "maker"), (True, "maker"), (True, "maker")]
    paths.clear()
    _, makers = sweep(teacher, None, cfg, jobs=[dict(jobs[0], guidance_scales=(1.0,))])
    assert makers == {"built": 0, "reused": 2}
    assert sorted((p is teacher_first, path) for p, path, _ in paths) == [
        (False, "maker"), (True, "maker")]


@pytest.mark.parametrize("scales", [(1.0, 3.0, 5.0), (3.0, 1.0, 5.0)], ids=["off_first", "mid"])
def test_sweep_runs_each_models_cfg_chains_before_its_cfg_off_chain(monkeypatch, scales):
    """Whatever the job's scale order, each model's CFG chains run before
    its CFG-off chain, the teacher's before the students' at each scale;
    the results equal those of the job in the order (1.0, 3.0, 5.0), and
    each returned dict lists the scales in the job's own order."""
    cfg = Config(device="cpu", **{**KW, "timesteps": 4})
    teacher, students = _resident_models(cfg)
    sweep, _, paths = _spied_sweep(monkeypatch)
    (got,), _ = sweep(teacher, students, cfg, guidance_scales=scales)
    order = [(p, cfg_on) for p, _, cfg_on in paths]
    firsts = [next(m.parameters()) for m in (teacher, *students.values())]
    assert len(order) == 3 * 3 and all(any(p is f for f in firsts) for p, _ in order)
    for f in firsts:
        mine = [cfg_on for p, cfg_on in order if p is f]
        assert mine == [True, True, False]
    assert [p is firsts[0] for p, _ in order] == [True, False, False] * 3
    for sf in students:
        for key in ("teacher_metrics", "student_metrics"):
            assert list(got[sf][key]) == list(scales)
    paths.clear()
    assert got == sweep(teacher, students, cfg, guidance_scales=(1.0, 3.0, 5.0))[0][0]
