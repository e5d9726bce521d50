"""The samplers' compiled chain on the CPU: the update kernel's row entry,
the chains' scalar tables, and each maker JAX puts under ``jax.jit``
against that jitted maker (float32, 16x16x1, sf 1.0 teacher and sf 0.1
student, T=6, JAX's draws injected; rtol 2e-5 / atol 1e-5, the tree's
sampler tolerance, ``tests/test_ops.py:60``) under either value of
``Config.pallas_cfg_update``; the benches' single-seed maker
(``sampling.make_chain_fn``) against the JAX benches' jitted
``generate_trajectory_scan``.  Each maker is called through both of its
entries, the plain call and ``eager=True``, and each entry is also held
bit for bit to the port's public function of the same chain
(``generate_trajectory_batch_scan``, ``generate_trajectory_scan``,
``p_sample_loop``), which the makers no longer route through.  On the CPU
both entries run the makers' eager body (there are no graphs);
``tests/test_torch_cuda.py`` holds the captured lane to it on the card.
The captured lane's bookkeeping (warm-ups, captures, the static sets the
keys of one signature share) runs here on a stand-in graph whose replay
runs the captured body again."""

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.sampling import (
    generate_trajectory_scan as jax_generate_trajectory_scan,
)
from distillation_trajectories_tpu.metrics.fid import make_sample_fn as jax_make_sample_fn
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import make_eval_model_fn as jax_make_eval_model_fn
from distillation_trajectories_tpu.training.progressive import (
    make_guided_eval_fn as jax_make_guided_eval_fn,
)
from distillation_trajectories_tpu.training.teacher import make_grid_fn as jax_make_grid_fn
from distillation_trajectories_tpu.trajectories import TrajectoryManager as JaxManager
from distillation_trajectories_tpu.trajectories import (
    make_batch_trajectory_fn as jax_make_batch_trajectory_fn,
)
from distillation_trajectories_tpu.trajectories import (
    make_paired_trajectory_fn as jax_make_paired_trajectory_fn,
)
from distillation_trajectories_tpu.trajectories import (
    make_sweep_trajectory_fn as jax_make_sweep_trajectory_fn,
)
from distillation_trajectories_torch.diffusion import get_diffusion_params, sampling
from distillation_trajectories_torch.diffusion.schedules import extract
from distillation_trajectories_torch.metrics.fid import make_sample_fn
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.ops.cfg_update import (
    cfg_engine_update,
    cfg_engine_update_row,
    cfg_engine_update_row_reference,
)
from distillation_trajectories_torch.training import make_eval_model_fn
from distillation_trajectories_torch.training.progressive import make_guided_eval_fn
from distillation_trajectories_torch.training.state import make_eval_fn_from_config
from distillation_trajectories_torch.training.teacher import make_grid_fn
from distillation_trajectories_torch.trajectories import (
    TrajectoryManager,
    make_batch_trajectory_fn,
    make_paired_trajectory_fn,
    make_sweep_trajectory_fn,
)
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    configs,
    cpu_graphs,
    jax_noises,
    jax_once,
    jax_step_noise,
    jax_variables,
    sample_draws,
    tmp_path,
)

torch.set_num_threads(2)

T = 6
SHAPE = (16, 16, 1)
TRAJ_TOL = dict(rtol=2e-5, atol=1e-5)
FLAGS = pytest.mark.parametrize("flag", [False, True], ids=["unfused", "fused"])
# A maker's two entries: its plain call and ``eager=True``.
ENTRIES = pytest.mark.parametrize("eager", [False, True], ids=["call", "eager"])


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("timesteps", [2, 10, 50, 100])
@pytest.mark.parametrize("g", [1.0, 3.0, 7.5])
def test_engine_table_rows_are_the_engine_scalars(timesteps, g):
    """Row ``j`` of a chain's table: step ``t = T-1-j``'s c1, c2, σ from
    ``_engine_scalars`` and g, bit for bit."""
    alphas = get_diffusion_params(timesteps)["alphas"]
    table = sampling._engine_table(timesteps, alphas, g)
    assert table.dtype == np.float32 and table.shape == (timesteps - 1, 4)
    for j, t in enumerate(range(timesteps - 1, 0, -1)):
        want = (*sampling._engine_scalars(alphas[t], alphas[t - 1]), np.float32(g))
        np.testing.assert_array_equal(_bits(table[j]), _bits(want))


@pytest.mark.parametrize("sample_steps, num_timesteps", [(10, 10), (100, 10), (7, 3)])
def test_loop_table_rows_are_the_extracted_coefficients(sample_steps, num_timesteps):
    """The loop's table holds what ``extract`` gathers a step, bit for bit."""
    dp = get_diffusion_params(sample_steps)
    indices = sampling.subsampled_timestep_indices(sample_steps, num_timesteps)
    table = sampling._loop_table(dp, indices)
    for j, t_index in enumerate(indices):
        t = torch.full((2,), int(t_index), dtype=torch.int32)
        want = [float(extract(dp[k], t, (2, 1))[0, 0]) for k in sampling._LOOP_COLUMNS]
        np.testing.assert_array_equal(_bits(table[j, :4]), _bits(want))
    np.testing.assert_array_equal(table[:, 4], 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1.0, 3.0, 7.5])
def test_row_entry_equals_the_float_call_bit_for_bit(dtype, g):
    """The plain version fed a table row (the chains' form) equals the
    float call, bit for bit, at every step of a T=10 table."""
    rng = np.random.default_rng(int(g * 10))
    ops = [torch.from_numpy(rng.standard_normal((2, 5, 3, 1)).astype(np.float32)).to(dtype)
           for _ in range(4)]
    alphas = get_diffusion_params(10)["alphas"]
    table = torch.from_numpy(sampling._engine_table(10, alphas, g))
    for j, t in enumerate(range(9, 0, -1)):
        scalars = (*sampling._engine_scalars(alphas[t], alphas[t - 1]), g)
        want = cfg_engine_update(*ops, *scalars)
        assert torch.equal(cfg_engine_update_row(*ops, table[j]), want)
        assert torch.equal(cfg_engine_update_row_reference(*ops, table[j]), want)
    assert cfg_engine_update.launches == 0


@pytest.fixture(scope="module")
def models():
    """Teacher sf 1.0 and student sf 0.1: port weights, carried into JAX."""
    _, tcfg = configs(timesteps=T, sample_steps=T)
    out = {}
    for name, sf, seed in (("teacher", 1.0, 0), ("student", 0.1, 1)):
        port = make_unet(tcfg, size_factor=sf, seed=seed, device="cpu")
        out[name] = (sf, port, jax_variables(port))
    return out


def _pair(models, flag):
    jcfg, tcfg = configs(timesteps=T, sample_steps=T, pallas_cfg_update=flag)
    jax_models = {k: (jax_make_unet(jcfg, size_factor=sf), v)
                  for k, (sf, _, v) in models.items()}
    return jcfg, tcfg, jax_models


def _draws(seeds):
    return jax_noises(seeds, SHAPE), torch.from_numpy(jax_step_noise(seeds, T, SHAPE))


@FLAGS
@ENTRIES
def test_sweep_and_batch_makers_match_jax(models, flag, eager):
    """``make_sweep_trajectory_fn`` (CFG at 3.0 and at 5.0 through one
    maker, then no-CFG) and ``make_batch_trajectory_fn`` against JAX's
    jitted makers, and each equal to ``generate_trajectory_batch_scan``
    bit for bit."""
    jcfg, tcfg, jm = _pair(models, flag)
    seeds = np.array([3, 11])
    noises, step_noise = _draws(seeds)
    alphas = get_diffusion_params(T, tcfg)["alphas"]
    teacher, student = models["teacher"][1], models["student"][1]
    jax_sweep = jax_make_sweep_trajectory_fn(*jm["teacher"], T, jcfg)
    sweep = make_sweep_trajectory_fn(teacher, T, tcfg)
    for pairs, gs in ((sampling.CFG_COND_PAIRS, 3.0), (sampling.CFG_COND_PAIRS, 5.0),
                      (sampling.NOCFG_COND_PAIRS, 1.0)):
        want = jax_once(("sampler_graph.sweep", flag, gs),
                         lambda: jax_sweep(noises, seeds, pairs, np.float32(gs)))
        got = sweep(torch.from_numpy(noises), seeds, pairs, gs, step_noise=step_noise,
                    eager=eager)
        assert got.shape == (2, T + 1, *SHAPE)
        np.testing.assert_allclose(got.numpy(), want, **TRAJ_TOL)
        assert torch.equal(got, sampling.generate_trajectory_batch_scan(
            make_eval_fn_from_config(teacher, tcfg), torch.from_numpy(noises), T, alphas,
            seeds, pairs, gs, step_noise=step_noise))

    want = jax_once(("sampler_graph.batch", flag), lambda: jax_make_batch_trajectory_fn(
        *jm["student"], T, jcfg, use_cfg=True)(noises, seeds, np.float32(7.5)))
    got = make_batch_trajectory_fn(student, T, tcfg, use_cfg=True)(
        noises, seeds, 7.5, step_noise=step_noise, eager=eager)
    np.testing.assert_allclose(got.numpy(), want, **TRAJ_TOL)
    assert torch.equal(got, sampling.generate_trajectory_batch_scan(
        make_eval_fn_from_config(student, tcfg), torch.from_numpy(noises), T, alphas, seeds,
        sampling.CFG_COND_PAIRS, 7.5, step_noise=step_noise))


@FLAGS
@ENTRIES
def test_paired_maker_and_manager_match_jax(models, flag, eager, tmp_path):
    """``make_paired_trajectory_fn`` (two calls of one maker; each chain
    also equal to ``generate_trajectory_batch_scan`` bit for bit) and the
    manager's paired chains (no CFG, its one paired function serving two
    seeds) against JAX's jitted ones."""
    jcfg, tcfg, jm = _pair(models, flag)
    alphas = get_diffusion_params(T, tcfg)["alphas"]
    fn = jax_make_paired_trajectory_fn(*jm["teacher"], *jm["student"], T, jcfg, use_cfg=True)
    port = make_paired_trajectory_fn(models["teacher"][1], models["student"][1], T, tcfg,
                                     use_cfg=True)
    for seeds, gs in (([3, 11], 3.0), ([5, 6], 2.0)):
        noises, step_noise = _draws(seeds)
        got = port(noises, seeds, gs, step_noise=step_noise, eager=eager)
        want = jax_once(("sampler_graph.paired", flag, gs),
                         lambda: np.stack(fn(noises, np.array(seeds), np.float32(gs))))
        for i, name in enumerate(("teacher", "student")):
            np.testing.assert_allclose(got[i].numpy(), want[i], **TRAJ_TOL)
            assert torch.equal(got[i], sampling.generate_trajectory_batch_scan(
                make_eval_fn_from_config(models[name][1], tcfg), torch.from_numpy(noises), T,
                alphas, seeds, sampling.CFG_COND_PAIRS, gs, step_noise=step_noise))

    jcfg.teacher_steps = tcfg.teacher_steps = T
    jcfg.base_dir, tcfg.base_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    (jt, tv), (js, sv) = jm["teacher"], jm["student"]

    jax_manager = []

    def jax_chains(seed):
        if not jax_manager:
            jax_manager.append(JaxManager(jt, js, jcfg, size_factor=0.1, teacher_variables=tv,
                                          student_variables=sv))
        return np.stack(jax_manager[0].generate_trajectory(seed))

    manager = TrajectoryManager(models["teacher"][1], models["student"][1], tcfg,
                                size_factor=0.1, device="cpu")
    for seed in (2, 9):
        noise, step_noise = _draws([seed])
        got = manager.generate_trajectory(seed, noise=torch.from_numpy(noise[0]),
                                          step_noise=step_noise[:, 0])
        want = jax_once(("sampler_graph.manager", flag, seed), lambda: jax_chains(seed))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TRAJ_TOL)


@FLAGS
@ENTRIES
def test_loop_makers_match_jax(models, flag, eager):
    """The FID sampler and the sample grid (``p_sample_loop`` under JAX's
    ``jax.jit``, weights as arguments) against JAX's: the maker's own
    model, then another model's weights through the same maker.  The
    grid's loop (``sampling.make_loop_fn``) is called through the entry
    under test and held to ``p_sample_loop`` bit for bit."""
    jcfg, tcfg, jm = _pair(models, flag)
    teacher, student = models["teacher"][1], models["student"][1]
    other = make_unet(tcfg, size_factor=1.0, seed=7, device="cpu")
    n = 2
    n_steps = len(sampling.subsampled_timestep_indices(tcfg.sample_steps, tcfg.timesteps))
    jax_sample = jax_make_sample_fn(jm["teacher"][0], jcfg, n)
    sample = make_sample_fn(teacher, tcfg, n)
    tcfg.num_samples_to_generate = jcfg.num_samples_to_generate = n
    dp = get_diffusion_params(T, tcfg)
    grid = make_grid_fn(student, tcfg, dp)
    jax_grid = jax_make_grid_fn(jm["student"][0], jcfg, jax_params(T, jcfg))
    student_b = make_unet(tcfg, size_factor=0.1, seed=8, device="cpu")
    for key, params, model in ((0, None, teacher), (1, other, other)):
        k = jax.random.PRNGKey(key)
        want = jax_once(("sampler_graph.sample", flag, key),
                        lambda: jax_sample(jax_variables(model), k))
        by_name = None if params is None else {**dict(params.named_parameters()),
                                               **dict(params.named_buffers())}
        got = sample(sample_draws(k, (n, *SHAPE), n_steps), by_name)
        np.testing.assert_allclose(got.numpy(), want, **TRAJ_TOL)
    for key, model in ((2, student), (3, student_b)):
        k = jax.random.PRNGKey(key)
        # The grid's params are parameters only: the buffers stay the
        # maker's model's, on both sides.
        want = jax_once(("sampler_graph.grid", flag, key), lambda: jax_grid(
            jax_variables(model)["params"], jax_variables(student)["batch_stats"], k))
        params = None if model is student else dict(model.named_parameters())
        noise, step_noise = sample_draws(k, (n, *SHAPE), n_steps)
        got = grid.loop(noise, step_noise, params, eager=eager)
        np.testing.assert_allclose(got.numpy(), want, **TRAJ_TOL)
        assert torch.equal(got, sampling.p_sample_loop(
            make_eval_model_fn(student, params), grid.shape, T, dp, noise=noise,
            step_noise=step_noise, num_timesteps=tcfg.timesteps, mode=tcfg.sample_mode))


# The benches' jitted chains (scripts/bench_quant.py:127, bench_r2.py:75,
# bench_fast.py:130, bench_progressive.py:59, 275, 283): the scale a Python
# constant of the program (CFG iff it is above 1.0, or no scale at all), or
# traced, as the progressive bench's w-sweep traces it (its teacher then
# runs CFG at every w, its guided student feeds cond=w).
CHAIN_CASES = {"cfg": (3.0,), "no_cfg": (None,), "traced_cfg": (1.0, 5.0), "guided": (2.0, 4.5)}


@FLAGS
@ENTRIES
@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_maker_matches_jax(models, flag, eager, case):
    """``make_chain_fn`` against JAX's jitted ``generate_trajectory_scan``
    (the benches' ``jax.jit(lambda vars, noise, seed: ...)``), one maker
    for every value of the case: the guided student's ``w`` is a tensor set
    in place before each call, the traced scale a ``use_cfg=True`` call.
    Each call also equals the port's ``generate_trajectory_scan`` bit for
    bit."""
    jcfg, tcfg, jm = _pair(models, flag)
    alphas = get_diffusion_params(T, tcfg)["alphas"]
    jalphas = jax_params(T, jcfg)["alphas"]
    name = "student" if case == "guided" else "teacher"
    (jmodel, jvars), port = jm[name], models[name][1]
    w_t = torch.zeros(())
    model_fn = make_guided_eval_fn(port, w_t) if case == "guided" else make_eval_model_fn(port)
    chain = sampling.make_chain_fn(model_fn, T, alphas, captures=lambda device: False)
    seed = 11
    noise, step_noise = _draws([seed])

    def jax_chain(g):
        if case == "guided":
            fn = lambda v, x, wv: jax_generate_trajectory_scan(  # noqa: E731
                jax_make_guided_eval_fn(jmodel, v, wv), x, T, jalphas, seed, use_pallas=flag)
            return jax.jit(fn)(jvars, noise, np.float32(g))
        if case == "traced_cfg":
            fn = lambda v, x, wv: jax_generate_trajectory_scan(  # noqa: E731
                jax_make_eval_model_fn(jmodel, v), x, T, jalphas, seed, guidance_scale=wv,
                use_pallas=flag)
            return jax.jit(fn)(jvars, noise, np.float32(g))
        fn = lambda v, x, s: jax_generate_trajectory_scan(  # noqa: E731
            jax_make_eval_model_fn(jmodel, v), x, T, jalphas, s, guidance_scale=g,
            use_pallas=flag)
        return jax.jit(fn)(jvars, noise, np.int32(seed))

    for g in CHAIN_CASES[case]:
        w_t.fill_(g or 0.0)
        kw = {"guidance_scale": None} if case == "guided" else {"guidance_scale": g}
        if case == "traced_cfg":
            kw["use_cfg"] = True
        got = chain(torch.from_numpy(noise), seed, step_noise=step_noise, eager=eager, **kw)
        assert got.shape == (T + 1, 1, *SHAPE)
        want = jax_once(("sampler_graph.chain", flag, case, g), lambda: jax_chain(g))
        np.testing.assert_allclose(got.numpy(), want, **TRAJ_TOL)
        assert torch.equal(got, sampling.generate_trajectory_scan(
            model_fn, torch.from_numpy(noise), T, alphas, seed, step_noise=step_noise, **kw))


def test_successive_calls_share_no_storage(models):
    """Two calls of each maker return tensors that share no storage, and
    the first result is unchanged after the second."""
    _, tcfg = configs(timesteps=T, sample_steps=T)
    tcfg.num_samples_to_generate = 2
    teacher, student = models["teacher"][1], models["student"][1]
    sweep = make_sweep_trajectory_fn(student, T, tcfg)
    paired = make_paired_trajectory_fn(teacher, student, T, tcfg, use_cfg=True)
    sample = make_sample_fn(student, tcfg, 2)
    grid = make_grid_fn(student, tcfg, get_diffusion_params(T, tcfg))
    n_steps = len(sampling.subsampled_timestep_indices(T, T))
    calls = {
        "sweep": lambda s: sweep(torch.from_numpy(_draws(s)[0]), s, sampling.CFG_COND_PAIRS,
                                 3.0, step_noise=_draws(s)[1]),
        "paired": lambda s: paired(_draws(s)[0], s, 3.0, step_noise=_draws(s)[1])[0],
        "sample": lambda s: sample(sample_draws(jax.random.PRNGKey(s[0]), (2, *SHAPE),
                                                n_steps)),
        "grid": lambda s: grid(*sample_draws(jax.random.PRNGKey(s[0]), (2, *SHAPE), n_steps)),
    }
    for name, call in calls.items():
        first = call([1, 2])
        kept = first.clone()
        second = call([3, 4])
        assert first.untyped_storage().data_ptr() != second.untyped_storage().data_ptr(), name
        assert torch.equal(first, kept) and not torch.equal(first, second), name


def _chain_makers(models):
    """``{name: call(cfg_on, gs, batch, eager)}`` of the two engine-chain
    makers of the student, each capturing (on the stand-in graphs)."""
    model_fn = make_eval_model_fn(models["student"][1])
    alphas = get_diffusion_params(T)["alphas"]
    noises, step_noise = _draws(np.array([3, 11]))
    noises = torch.from_numpy(noises)
    batch = sampling.make_batch_chain_fn(model_fn, T, alphas, captures=lambda device: True)
    chain = sampling.make_chain_fn(model_fn, T, alphas, captures=lambda device: True)
    return {
        "batch": (batch, lambda cfg_on, gs, b, eager=False: batch(
            noises[:b], [3, 11][:b], sampling.CFG_COND_PAIRS if cfg_on else
            sampling.NOCFG_COND_PAIRS, gs, step_noise=step_noise[:, :b], eager=eager)),
        "chain": (chain, lambda cfg_on, gs, b, eager=False: chain(
            noises[:b], 3, gs, use_cfg=cfg_on, step_noise=step_noise[:, :b], eager=eager)),
    }


@pytest.mark.parametrize("name", ["batch", "chain"])
def test_cfg_and_cfg_off_keys_share_one_static_set(models, cpu_graphs, name):
    """A maker's CFG key warms its input signature up and is captured on
    its second call; the CFG-off key of that signature is then captured on
    its first call, on the same static inputs and output (one static
    set); every replay equals the eager body, returns storage
    of its own, and leaves an earlier result as it was.  Another batch
    size is another signature: its own warm-up and static set."""
    from distillation_trajectories_torch.utils.profiling import recording

    fn, call = _chain_makers(models)[name]
    with recording() as rec:
        call(True, 3.0, 2)
        call(True, 5.0, 2)
        off = call(False, 1.0, 2)
        on = call(True, 3.0, 2)
        kept = on.clone()
        again = call(False, 1.0, 2)
    steps = [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)
             if s.name.startswith("graph.")]
    assert steps == ["graph.warmup", "graph.capture", "graph.replay", "graph.capture",
                     "graph.replay", "graph.replay", "graph.replay"]
    assert torch.equal(on, kept) and torch.equal(on, call(True, 3.0, 2, eager=True))
    assert torch.equal(off, again) and torch.equal(off, call(False, 1.0, 2, eager=True))
    cfg_graph, off_graph = fn.graphs.graphs.values()
    assert len(fn.graphs._statics) == 1 and cfg_graph.output is off_graph.output
    assert [a.data_ptr() for a in cfg_graph.inputs] == [a.data_ptr() for a in off_graph.inputs]
    ptrs = {t.untyped_storage().data_ptr() for t in (on, off, again, cfg_graph.output)}
    assert len(ptrs) == 4
    with recording() as rec:
        call(False, 1.0, 1)
        call(True, 3.0, 1)
    assert [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)] == [
        "graph.warmup", "graph.capture", "graph.replay"]
    assert len(fn.graphs._statics) == 2 and len(fn.graphs.graphs) == 3


def test_loop_maker_captures_into_its_static_output(models, cpu_graphs):
    """The grid's loop maker on the stand-in graphs: warm-up, capture, then
    replays, each equal to the eager body, its final image copied into
    the one static set's output and returned as a copy of it."""
    model = models["student"][1]
    dp = get_diffusion_params(T)
    loop = sampling.make_loop_fn(lambda params: make_eval_model_fn(model, params), (2, *SHAPE),
                                 T, dp, captures=lambda device: True)
    noise, step_noise = sample_draws(jax.random.PRNGKey(4), (2, *SHAPE), T)
    outs = [loop(noise, step_noise) for _ in range(3)]
    want = loop(noise, step_noise, eager=True)
    assert all(torch.equal(o, want) for o in outs)
    (graph,) = loop.graphs.graphs.values()
    assert len(loop.graphs._statics) == 1 and torch.equal(graph.output, want)
    assert outs[2].untyped_storage().data_ptr() != graph.output.untyped_storage().data_ptr()
