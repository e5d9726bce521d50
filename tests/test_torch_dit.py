"""The DiT transformer of the port (``models/dit.py``) on the CPU, at tiny
widths with seeded random weights (every adaLN and final weight nonzero):
its forward against the plain reference (``h100_bench/reference/dit.py``), the
``(cond, mask)`` to label / null-class mapping, a whole sweep call with a
DiT teacher and two DiT students against the reference chain and metric
suite, the labels' draw, the factory and the published sizes, the U-Net
sweep unchanged bit for bit, every path built for the U-Net refusing a
DiT (the teacher's trainer takes one, ``test_torch_dit_train.py``, but not
on the mesh lane), and the adaLN passes: their plain versions bit-equal to the published
block's composition, the trunk's seams through them, and their module
importing no Triton."""

import hashlib
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.diffusion.sampling import (
    CFG_COND_PAIRS,
    LABEL_STREAM,
    _generator_seed,
    sample_labels,
)
from distillation_trajectories_torch.models import make_model, make_unet
from distillation_trajectories_torch.models.dit import DIT_VARIANTS, DiT, timestep_embedding
from distillation_trajectories_torch.trajectories.engine import (
    _sweep_inputs,
    make_sweep_trajectory_fn,
    sweep_compare_trajectories_multi,
)
from distillation_trajectories_torch.utils.profiling import recording
from h100_bench.reference import chain as ref_chain
from h100_bench.reference import dit as R
from h100_bench.reference import metrics as ref_metrics
from h100_bench.yardstick import draws as D
from h100_bench.yardstick.schedule import linear_schedule
from torch_parity import tmp_path  # noqa: F401  (each test's outputs removed when it ends)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = dict(depth=2, hidden_size=64, num_heads=4)
STUDENTS = {"B": dict(depth=1, hidden_size=32, num_heads=2),
            "S": dict(depth=1, hidden_size=48, num_heads=4)}
# Float32 against float32: the fused CPU attention and the written-out
# softmax sum in other orders, a few ulp through two blocks (2.6e-7 of the
# output's scale measured); 1e-5 leaves ~40x room, and bf16 autocast misses
# it by ~1,000x.
RTOL = ATOL = 1e-5


def _sizes(v):
    return R.sizes(v["depth"], v["hidden_size"], v["num_heads"], input_size=8)


def _dit(v, seed, dtype=torch.float32):
    model = DiT(input_size=8, in_channels=4, dtype=dtype, **v)
    weights = R.make_weights(_sizes(v), seed, "cpu")
    missing, unexpected = model.load_state_dict(weights, strict=False)
    assert missing == ["pos_embed"] and not unexpected
    return model.eval(), weights


def _inputs(b=6, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 8, 8, 4), generator=gen)
    t = torch.randint(0, 50, (b,), generator=gen).float()
    cond = torch.tensor([[0.], [1.], [1.], [0.], [1.], [2.]])[:b]
    mask = torch.tensor([[1.], [1.], [0.], [0.], [1.], [1.]])[:b]
    labels = torch.randint(0, 1000, (b,), generator=gen)
    return x, t, cond, mask, labels


def test_forward_matches_the_reference_and_bf16_does_not():
    model, w = _dit(TEACHER, 3)
    x, t, cond, mask, labels = _inputs()
    with torch.no_grad():
        got = model(x, t, cond, mask, labels)
        want = R.forward(w, x, t, cond, mask, labels, _sizes(TEACHER))
        low = _dit(TEACHER, 3, torch.bfloat16)[0](x, t, cond, mask, labels)
    assert got.shape == (6, 8, 8, 4) and got.dtype == torch.float32 and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert not torch.allclose(low, want, rtol=RTOL, atol=ATOL)
    assert (low - want).abs().max() > 100 * ATOL


def test_position_table_and_timestep_embedding_are_the_published_ones():
    model = DiT(input_size=8, in_channels=4, **TEACHER)
    torch.testing.assert_close(model.pos_embed, R.pos_embed(64, 4), rtol=0, atol=0)
    t = torch.tensor([0.0, 3.0, 999.0])
    assert model.t_embedder.mlp[0].in_features == 256
    torch.testing.assert_close(timestep_embedding(t), R.timestep_embedding(t), rtol=0, atol=0)


# (cond, mask) -> does the sample take its label?  Else the null class.
MAPPING = [((0.0, 1.0), False), ((1.0, 1.0), True), ((0.0, 0.0), False), ((1.0, 0.0), False),
           ((2.0, 1.0), True), ((-1.0, 1.0), False), ((1.0, None), True), ((None, None), False)]


@pytest.mark.parametrize("cond_mask, takes_label", MAPPING)
def test_cond_and_mask_map_to_label_or_null(cond_mask, takes_label):
    model = DiT(input_size=8, in_channels=4, **TEACHER)
    c, m = cond_mask
    cond = None if c is None else torch.full((3, 1), c)
    mask = None if m is None else torch.full((3, 1), m)
    labels = torch.tensor([5, 0, 999])
    got = model.classes(cond, mask, labels, 3, "cpu")
    want = labels if takes_label else torch.full((3,), 1000)
    assert torch.equal(got, want)
    assert torch.equal(model.classes(cond, mask, None, 3, "cpu"), torch.full((3,), 1000))


def test_the_engine_cfg_rows_are_null_against_label():
    """Through the eval forward the CFG pair's first row is the null class
    and its second the label: each equals the model run on those classes
    with the mask forced, and the two differ."""
    model, w = _dit(TEACHER, 4)
    x, t, _, _, labels = _inputs()
    (u_c, u_m), (c_c, c_m) = CFG_COND_PAIRS
    full = lambda v: torch.full((6, 1), float(v))
    with torch.no_grad():
        uncond = model(x, t, full(u_c), full(u_m), labels)
        cond = model(x, t, full(c_c), full(c_m), labels)
        null = R.forward(w, x, t, full(0), full(0), labels, _sizes(TEACHER))
        label = R.forward(w, x, t, full(1), full(1), labels, _sizes(TEACHER))
    torch.testing.assert_close(uncond, null, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(cond, label, rtol=RTOL, atol=ATOL)
    assert (cond - uncond).abs().max() > 1e-2


def test_labels_come_from_each_sample_seed_alone():
    seeds = [11, 12, 13, 2 ** 31 + 5]
    got = sample_labels(seeds, 1000, "cpu")
    want = [_generator_seed(s, LABEL_STREAM) % 1000 for s in seeds]
    assert got.dtype == torch.int64 and got.tolist() == want
    assert got.tolist() == [D.generator_seed(s, LABEL_STREAM) % 1000 for s in seeds]
    assert torch.equal(sample_labels(seeds[::-1], 1000, "cpu"), got.flip(0))
    assert torch.equal(sample_labels(seeds[1:3], 1000, "cpu"), got[1:3])
    many = sample_labels(range(20_000), 1000, "cpu")
    assert many.min() >= 0 and many.max() <= 999
    counts = torch.bincount(many, minlength=1000).float()
    assert counts.std() < 2 * counts.mean().sqrt()  # ~ a uniform draw's spread


def test_sweep_draws_hold_labels_for_a_dit_and_none_for_the_unet(tmp_path):
    cfg = Config(base_dir=str(tmp_path), device="cpu", image_size=8, channels=4)
    dit = _sweep_inputs(cfg, 3, 40, 5, 1000, "cpu")
    assert torch.equal(dit.labels, sample_labels([40, 41, 42], 1000, "cpu"))
    with recording() as rec:
        assert _sweep_inputs(cfg, 3, 40, 5, None, "cpu").labels is None
        _sweep_inputs(cfg, 3, 40, 5, 1000, "cpu")
    assert [s.attrs for s in rec.spans if s.attrs.get("kind") == "labels"] == [
        {"n": 3, "kind": "labels"}]


def test_dit_sweep_matches_the_reference_chain_and_metric_suite(tmp_path):
    """A whole sweep call (DiT teacher, two DiT students, 3 samples, T=5,
    scales 1, 3 and 5, float32) against the plain reference's chains on the
    same draws and labels and the plain metric suite."""
    torch.manual_seed(0)
    cfg = Config(base_dir=str(tmp_path), device="cpu", image_size=8, channels=4, timesteps=5,
                 compute_dtype="float32", architecture="dit")
    teacher, tw = _dit(TEACHER, 10)
    students = {k: _dit(v, 11 + i) for i, (k, v) in enumerate(STUDENTS.items())}
    scales, base, S, T = (1.0, 3.0, 5.0), 77, 3, 5
    job = {"students": {k: m for k, (m, _) in students.items()}, "guidance_scales": scales,
           "num_samples": S, "base_seed": base, "timesteps": T}
    with recording() as rec:
        got = sweep_compare_trajectories_multi(teacher, [job], cfg, verbose=False)[0]
    forwards = [s for s in rec.spans if s.name == "dit.forward"]
    assert forwards and forwards[0].attrs == {
        "variant": teacher.variant, "batch": S, "tokens": 16, "heads": 4, "head_dim": 16,
        "backends": ("flash", "cudnn", "efficient"), "adaln": "plain", "grad": False}

    seeds = [base + i for i in range(S)]
    noises = D.seeded_normal([(s, 0) for s in seeds], (8, 8, 4), "cpu")
    step_noise = D.step_noise(seeds, T, (8, 8, 4), "cpu")
    labels = torch.tensor([D.generator_seed(s, LABEL_STREAM) % 1000 for s in seeds])
    alphas = linear_schedule(T, 1e-4, 0.02)["alphas"]

    def ref(w, v):
        return lambda x, t, c, m: R.forward(w, x, t, c, m, labels, _sizes(v))

    with torch.no_grad():
        for gs in scales:
            t_traj = ref_chain.chain(ref(tw, TEACHER), noises, step_noise, alphas, T, gs > 1, gs)
            for k, (_, w) in students.items():
                s_traj = ref_chain.chain(ref(w, STUDENTS[k]), noises, step_noise, alphas, T,
                                         gs > 1, gs)
                want = ref_metrics.scalar_metrics(t_traj, s_traj, None)
                have = got[k]["student_metrics"][gs]
                for name, vec in want.items():
                    np.testing.assert_allclose(have[name], float(vec.mean()), rtol=1e-4,
                                               atol=1e-6, equal_nan=True, err_msg=name)


def test_dit_chain_takes_labels_as_an_input(tmp_path):
    """The sweep maker's chain of a DiT: other labels, other trajectories;
    the same labels in another order, the same trajectories reordered."""
    cfg = Config(base_dir=str(tmp_path), device="cpu", image_size=8, channels=4, timesteps=5,
                 compute_dtype="float32", architecture="dit")
    model, _ = _dit(TEACHER, 2)
    fn = make_sweep_trajectory_fn(model, 5, cfg)
    x, *_ = _inputs(3, seed=5)
    step = torch.randn((4, 3, 8, 8, 4), generator=torch.Generator().manual_seed(6))
    a = fn(x, [1, 2, 3], CFG_COND_PAIRS, 4.0, step_noise=step, labels=torch.tensor([1, 2, 3]))
    b = fn(x, [1, 2, 3], CFG_COND_PAIRS, 4.0, step_noise=step, labels=torch.tensor([4, 2, 3]))
    assert not torch.allclose(a[0], b[0]) and torch.allclose(a[1:], b[1:], rtol=0, atol=0)


def test_unet_sweep_is_bit_equal_to_before(tmp_path):
    """The U-Net's sweep, with no labels, computes what it computed before
    the labels were threaded through the chain: the digests of a call's
    metric means and of a chain's trajectories are those the chain gave
    before (one CPU thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = Config(base_dir=str(tmp_path), device="cpu", image_size=16, channels=1,
                     timesteps=6, compute_dtype="float32")
        teacher = make_unet(cfg, size_factor=0.2, seed=5)
        students = {0.1: make_unet(cfg, size_factor=0.1, seed=1),
                    0.2: make_unet(cfg, size_factor=0.2, seed=2)}
        job = {"students": students, "guidance_scales": (1.0, 3.0), "num_samples": 3,
               "base_seed": 11, "timesteps": 6}
        out = sweep_compare_trajectories_multi(teacher, [job], cfg, verbose=False)[0]
        h = hashlib.sha256()
        for sf in sorted(students):
            for gs in (1.0, 3.0):
                for k in sorted(out[sf]["student_metrics"][gs]):
                    h.update(np.float64(out[sf]["student_metrics"][gs][k]).tobytes())
        assert h.hexdigest() == "41efc66d7418b732e58b39a477f7d60d3ca60fc221a2dff346b2ae1b13e5f120"
        fn = make_sweep_trajectory_fn(teacher, 6, cfg)
        noises = torch.randn((3, 16, 16, 1), generator=torch.Generator().manual_seed(3))
        traj = fn(noises, [1, 2, 3], CFG_COND_PAIRS, 3.0).numpy().tobytes()
        assert hashlib.sha256(traj).hexdigest() == (
            "321d95e672edd455426bb0fb72a122420fec833305810710c9f307053e5cdd28")
    finally:
        torch.set_num_threads(threads)


PUBLISHED = {"DiT-XL/2": 675e6, "DiT-B/2": 130e6, "DiT-S/2": 33e6}


@pytest.mark.parametrize("variant", sorted(PUBLISHED))
def test_published_variants_build_at_their_sizes(variant):
    """Each variant at its published widths (on the meta device) has the
    parameters DiT reports within 0.5%, exactly those the benchmark's
    configuration file records and the reference's spec counts."""
    with open(os.path.join(ROOT, "h100_bench", "configs", "dit-xl2-256.json")) as f:
        recorded = json.load(f)
    with torch.device("meta"):
        model = DiT(input_size=32, in_channels=4, variant=variant, **DIT_VARIANTS[variant])
    n = sum(p.numel() for p in model.parameters())
    assert abs(n / PUBLISHED[variant] - 1) < 0.005
    assert n == recorded["params"][variant]
    assert n + model.pos_embed.numel() == recorded["params_with_pos_embed"][variant]
    v = DIT_VARIANTS[variant]
    assert n == R.param_count(R.sizes(v["depth"], v["hidden_size"], v["num_heads"]))
    assert recorded["variants"][variant] == {k: v[k] for k in ("depth", "hidden_size",
                                                               "num_heads")}


def test_make_model_builds_by_architecture(tmp_path):
    unet_cfg = Config(base_dir=str(tmp_path), device="cpu")
    assert type(make_model(unet_cfg, 0.1)).__name__ == "DiffusionUNet"
    cfg = Config(base_dir=str(tmp_path), device="cpu", image_size=8, channels=4,
                 architecture="dit")
    model = make_model(cfg, "DiT-S/2", seed=3)
    assert isinstance(model, DiT) and model.variant == "DiT-S/2"
    again = make_model(cfg, "DiT-S/2", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    # Every adaLN and final weight is drawn, none left at zero.
    for name, p in model.named_parameters():
        if "adaLN" in name or "final_layer" in name:
            assert p.abs().min() > 0 or p.abs().mean() > 1e-3, name
    with pytest.raises(ValueError, match="unknown DiT variant"):
        make_model(cfg, "DiT-Q/7")
    with pytest.raises(ValueError, match="unknown architecture"):
        make_model(Config(base_dir=str(tmp_path), device="cpu", architecture="vit"))


def _refusals(tmp_path):
    """``{path: call}``: each path built for the U-Net, handed a DiT."""
    from distillation_trajectories_torch.editing.core import editing_device
    from distillation_trajectories_torch.metrics.fid import make_sample_fn
    from distillation_trajectories_torch.models.quantized import make_quantized_eval_fn
    from distillation_trajectories_torch.parallel.mesh import shard_params, shard_train_state
    from distillation_trajectories_torch.parallel.spatial import make_spatial_forward
    from distillation_trajectories_torch.training.progressive import progressive_distill
    from distillation_trajectories_torch.training.state import (
        TorchDraws,
        create_train_state,
        make_eval_fn_from_config,
    )
    from distillation_trajectories_torch.training.students import (
        distill_diffusion_model,
        train_students,
    )
    from distillation_trajectories_torch.training.teacher import train_teacher
    from distillation_trajectories_torch.trajectories.manager import TrajectoryManager

    kw = dict(base_dir=str(tmp_path), device="cpu", image_size=8, channels=4)
    dit_cfg = Config(architecture="dit", **kw)
    cfg = Config(**kw)
    dit = DiT(input_size=8, in_channels=4, variant="DiT-S/2", **TEACHER)
    unet = make_unet(Config(base_dir=str(tmp_path), device="cpu"), 0.1)
    return {
        "train_teacher": lambda: train_teacher(Config(architecture="dit", mesh_shape=(2, 1),
                                                      **kw)),
        "train_students": lambda: train_students(dit_cfg, [0.1]),
        "make_unet": lambda: make_unet(dit_cfg),
        "trainer_state": lambda: shard_train_state(create_train_state(dit, cfg,
                                                                      TorchDraws(0, "cpu")), None),
        "distill": lambda: distill_diffusion_model(dit, cfg),
        "progressive": lambda: progressive_distill(cfg, dit),
        "manager": lambda: TrajectoryManager(dit, unet, cfg),
        "int8": lambda: make_quantized_eval_fn(dit),
        "int8_config": lambda: make_eval_fn_from_config(dit, Config(sampler_quant="int8", **kw)),
        "spatial": lambda: make_spatial_forward(dit, None),
        "spatial_config": lambda: make_eval_fn_from_config(dit, Config(spatial_shape=(1, 2), **kw)),
        "mesh": lambda: shard_params(dit, None),
        "sweep_mesh": lambda: sweep_compare_trajectories_multi(
            dit, [{"students": {"S": dit}}], Config(mesh_shape=(2, 1), **kw), verbose=False),
        "fid": lambda: make_sample_fn(dit, cfg, 2),
        "editing": lambda: editing_device(dit, cfg),
    }


REFUSALS = ["train_teacher", "train_students", "make_unet", "trainer_state", "distill",
            "progressive", "manager", "int8", "int8_config", "spatial", "spatial_config", "mesh",
            "sweep_mesh", "fid", "editing"]


@pytest.mark.parametrize("path", REFUSALS)
def test_unet_paths_refuse_a_dit(tmp_path, path):
    with pytest.raises(ValueError, match="U-Net only; got architecture 'dit'"):
        _refusals(tmp_path)[path]()


def test_a_sweep_does_not_mix_the_families(tmp_path):
    cfg = Config(base_dir=str(tmp_path), device="cpu", image_size=8, channels=4)
    dit = DiT(input_size=8, in_channels=4, **TEACHER)
    unet = make_unet(Config(base_dir=str(tmp_path), device="cpu", image_size=8, channels=4), 0.1)
    with pytest.raises(ValueError, match="all be U-Nets or all be"):
        sweep_compare_trajectories_multi(dit, [{"students": {0.1: unet}}], cfg, verbose=False)
    draws = _sweep_inputs(cfg, 2, 5, 4, None, "cpu")  # no labels
    with pytest.raises(ValueError, match="draws carry labels"):
        sweep_compare_trajectories_multi(dit, [{"students": {"S": dit}, "draws": draws,
                                                "timesteps": 4}], cfg, verbose=False)


def _published_ln_modulate(x, shift, scale):
    """The published block's ``modulate(norm(x), shift, scale)``."""
    norm = torch.nn.LayerNorm(x.shape[-1], elementwise_affine=False, eps=1e-6)
    return norm(x) * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


@pytest.mark.parametrize("autocast", [False, True], ids=["float32", "bf16-autocast"])
def test_adaln_plain_versions_are_the_published_composition_bit_for_bit(autocast):
    """The plain versions compute ``modulate(norm(x), shift, scale)`` and
    ``x + gate·y`` as the published block writes them, bit for bit, in
    float32 and under bf16 autocast (bf16 modulations and branch output);
    the wrappers take them on CPU tensors and count no launch, the gated
    one writing ``x'`` over its ``x`` as on the card."""
    from distillation_trajectories_torch.ops import adaln

    gen = torch.Generator().manual_seed(7)
    low = torch.bfloat16 if autocast else torch.float32
    x = torch.randn((3, 10, 48), generator=gen) * 2
    y = torch.randn((3, 10, 48), generator=gen).to(low)
    gate, shift, scale = torch.randn((3, 6 * 48), generator=gen).to(low).chunk(6, dim=1)[:3]
    before = adaln.ln_modulate.launches, adaln.gate_add_ln_modulate.launches
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        h = adaln.ln_modulate_reference(x, shift, scale)
        want_h = _published_ln_modulate(x, shift, scale)
        x2, h2 = adaln.gate_add_ln_modulate_reference(x, y, gate, shift, scale)
        want_x2 = x + gate.unsqueeze(1) * y
        want_h2 = _published_ln_modulate(want_x2, shift, scale)
        x_in = x.clone()
        wrapped = adaln.ln_modulate(x, shift, scale), *adaln.gate_add_ln_modulate(
            x_in, y, gate, shift, scale)
    assert h.dtype == torch.float32 and x2.dtype == torch.float32
    for got, want in zip((h, x2, h2) + tuple(wrapped), (want_h, want_x2, want_h2) * 2):
        assert torch.equal(got, want)
    assert wrapped[1] is x_in
    assert (adaln.ln_modulate.launches, adaln.gate_add_ln_modulate.launches) == before


def test_adaln_module_imports_no_triton_on_the_cpu():
    code = ("import sys; import distillation_trajectories_torch.ops.adaln; "
            "import distillation_trajectories_torch.models.dit; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'triton'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert out.strip() == "[]"


def test_trunk_joins_each_seam_in_one_gated_pass():
    """The trunk runs one ``ln_modulate`` (the first block's attention
    input) and two ``gate_add_ln_modulate`` a block (attention to MLP, and
    the block's end to the next block's or the final layer's norm), with
    each block's own gates and the next normalisation's shift and scale;
    through the wrappers on the CPU it equals the trunk of the pure plain
    versions bit for bit."""
    from distillation_trajectories_torch.models import dit
    from distillation_trajectories_torch.ops import adaln

    model, _ = _dit(TEACHER, 5)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((2, 16, 64), generator=gen)
    c = torch.randn((2, 64), generator=gen)
    calls = []

    def spy(name, fn):
        def call(*args):
            calls.append((name, args[-2:]))
            return fn(*args)
        return call

    with torch.no_grad():
        with mock.patch.object(dit, "ln_modulate", adaln.ln_modulate_reference), \
                mock.patch.object(dit, "gate_add_ln_modulate",
                                  adaln.gate_add_ln_modulate_reference):
            plain = model.trunk(x.clone(), c)
        with mock.patch.object(dit, "ln_modulate", spy("ln", dit.ln_modulate)), \
                mock.patch.object(dit, "gate_add_ln_modulate",
                                  spy("gated", dit.gate_add_ln_modulate)):
            got = model.trunk(x.clone(), c)  # the trunk updates its x in place
        mods = [b.adaLN_modulation(c).chunk(6, dim=1) for b in model.blocks]
        final = model.final_layer.adaLN_modulation(c).chunk(2, dim=1)
    assert torch.equal(got, plain)
    names = [n for n, _ in calls]
    assert names == ["ln"] + ["gated"] * (2 * TEACHER["depth"])
    want = [mods[0][:2]]
    for i, m in enumerate(mods):
        want += [m[3:5], (mods[i + 1] if i + 1 < len(mods) else final)[:2]]
    for (_, got_mods), want_mods in zip(calls, want):
        assert all(torch.equal(a, b) for a, b in zip(got_mods, want_mods))
