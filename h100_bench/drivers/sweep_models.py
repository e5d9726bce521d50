"""The trajectory sweep with the teacher and the students the traffic names:
one ``sweep_compare_trajectories_multi`` call per job, back to back.

The configuration says the family (``"architecture"``: the U-Net, keyed
by size factor, or the DiT, keyed by variant name); the traffic names the
teacher and the students, the guidance scales and ``num_samples`` samples
at ``timesteps`` steps.  Each model is built through the program's factory
(``models.make_model``) and given the benchmark's seeded weights (a DiT
keeps its own fixed position table, which the reference works out apart);
the driver keeps each model's seed, not a copy of its weights, and the
check draws them again.
Each call's ``base_seed`` comes from ``--seed`` and the call's index; the
program draws the call's noise, and a DiT's class labels, from it, as
users' sweeps do.  Set-up makes one whole call; the makers are resident
after it, so the window's calls replay the chains set-up captured and run
each model's CFG-off chain eagerly (it runs once a call).

The check draws one call of the window, some of its scales and some of
its students from the seed (``check`` in the traffic), works out the same
draws, runs the plain reference's chains at the configuration's precision
and the metric suite, and compares the metric means the program returned
with the reference's: the widest gap over metrics, students and scales
(``sweep_metric_gap``).  Controls: ``program_int8`` (the U-Net's int8
lane) and ``reference_fp8`` (the reference with fp8-rounded operands).

On the CPU (the rehearsal tests alone: the harness refuses a host without
the card) the driver cuts the cell as ``tests/tiny.py`` cuts the ``sweep``
driver's, its DiTs to tiny widths.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from h100_bench import program
from h100_bench.drivers.sweep import SCORES
from h100_bench.reference import chain as ref_chain
from h100_bench.reference import compare
from h100_bench.reference import dit as ref_dit
from h100_bench.reference import metrics as ref_metrics
from h100_bench.reference import unet as ref_unet
from h100_bench.yardstick import draws as D
from h100_bench.yardstick.dit_flops import attention_bytes, dit_forward_flops
from h100_bench.yardstick.flops import cfg_update_bytes, forward_flops
from h100_bench.yardstick.schedule import linear_schedule
from h100_bench.yardstick.weights import make_weights

WARM = 10 ** 6  # index of set-up's call; the traced slice's is WARM + 1
LABEL_STREAM = 0xFFFFFFFF  # the label's generator key (seed, LABEL_STREAM)
TINY_DIT = {"depth": 2, "hidden_size": 64, "num_heads": 4}
TINY_DIT_STUDENT = {"depth": 1, "hidden_size": 32, "num_heads": 2}


def trajectory_mse_gap(program: float, reference: float) -> float:
    """``trajectory_mse`` is ``log(2 - 1000 m)`` of each sample's trajectory
    MSE ``m``: bounded above, not below, so its absolute gap grows without
    bound as a sample's ``m`` nears 2e-3 (on the H100 the CFG CLI's cell,
    10 samples a mean, read gaps up to 4.7e-3 there and under 1e-3 in every
    other metric).  It is
    compared as the MSE its mean stands for, ``(2 - exp(v)) / 1000``, by
    relative gap, as the suite's other distances are."""
    return compare.relative_gap(2.0 - math.exp(program), 2.0 - math.exp(reference))


def cpu_cut(cfg: dict, tr: dict):
    """The cell at a size a CPU test run holds: 4 samples, T=5, three
    scales, the check's students alone; a DiT at 8x8x4 and tiny widths."""
    tr = dict(tr, num_samples=4, timesteps=5, guidance_scales=[1.0, 3.0, 5.0],
              students=list(tr["check"]["students_always"]),
              check=dict(tr["check"], scales_always=[1.0, 5.0], scales_drawn=1,
                         students_drawn=0))
    if cfg.get("architecture") == "dit":
        variants = {name: (TINY_DIT if name == tr["teacher"] else TINY_DIT_STUDENT)
                    for name in cfg["variants"]}
        cfg = dict(cfg, image_size=8, channels=4, compute_dtype="float32", variants=variants)
    return cfg, tr


def labels_of(seeds, num_classes: int, device) -> torch.Tensor:
    """Each sample's class from its seed alone: splitmix64 of ``(seed,
    LABEL_STREAM)`` modulo ``num_classes`` (the program's documented
    stream)."""
    return torch.tensor([D.generator_seed(int(s), LABEL_STREAM) % num_classes for s in seeds],
                        dtype=torch.int64, device=device)


class ModelsSweepRun:
    def __init__(self, ctx):
        cfg, tr = ctx.config, ctx.traffic
        if ctx.device.type == "cpu":
            cfg, tr = cpu_cut(cfg, tr)
        self.ctx, self.cfg, self.tr = ctx, cfg, tr
        self.dit = cfg.get("architecture") == "dit"
        self.S, self.T = int(tr["num_samples"]), int(tr["timesteps"])
        self.scales = [float(g) for g in tr["guidance_scales"]]
        key = (lambda k: str(k)) if self.dit else (lambda k: float(k))
        self.teacher_key = key(tr["teacher"])
        self.keys = [key(k) for k in tr["students"]]
        self.shape = (cfg["image_size"], cfg["image_size"], cfg["channels"])
        self.seed0 = D.derive(ctx.seed, "sweep_models") % 2 ** 30
        self.dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
        dev = ctx.device
        self.config = self.port_config(ctx)
        self.seeds, models = {}, {}
        for role, k in [("teacher", self.teacher_key)] + [("student", k) for k in self.keys]:
            self.seeds[(role, k)] = seed = D.derive(ctx.seed, f"weights/{role}/{k}")
            models[(role, k)] = self.build(k, seed, dev)
            self.load_weights(models[(role, k)], k, seed, dev)
        self.teacher = models[("teacher", self.teacher_key)]
        self.students = {k: models[("student", k)] for k in self.keys}
        from distillation_trajectories_torch.trajectories.engine import (
            sweep_compare_trajectories_multi,
        )
        self._sweep = sweep_compare_trajectories_multi
        self.results: Dict[int, dict] = {}
        self.call_flops = self.forwards() * sum(sum(f.values()) for f in self.flops())
        self.call(WARM)

    # -- the program -------------------------------------------------------------

    def port_config(self, ctx):
        cfg = self.cfg
        if not self.dit:
            quant = "int8" if ctx.control == "program_int8" else "none"
            return program.port_config(cfg, ctx.device, ctx.workdir, timesteps=self.T,
                                       sampler_quant=quant)
        from distillation_trajectories_torch.config import Config

        return Config(image_size=cfg["image_size"], channels=cfg["channels"], timesteps=self.T,
                      beta_start=cfg["beta_start"], beta_end=cfg["beta_end"],
                      noise_schedule=cfg["noise_schedule"], compute_dtype=cfg["compute_dtype"],
                      architecture="dit", base_dir=ctx.workdir, device=str(ctx.device))

    def build(self, k, seed: int, device) -> torch.nn.Module:
        """A model through the program's factory; on the CPU a DiT at the
        cut's tiny widths through the program's class."""
        if self.dit and device.type == "cpu":
            from distillation_trajectories_torch.models.dit import DiT

            return DiT(input_size=self.shape[0], in_channels=self.shape[2], variant=k,
                       dtype=self.dtype, **self.cfg["variants"][k])
        from distillation_trajectories_torch.models import make_model

        return make_model(self.config, k, device=device, seed=seed % 2 ** 31)

    def dit_sizes(self, k) -> dict:
        v = self.cfg["variants"][k]
        return ref_dit.sizes(v["depth"], v["hidden_size"], v["num_heads"],
                             patch=self.cfg["patch_size"], channels=self.shape[2],
                             input_size=self.shape[0], mlp_ratio=self.cfg["mlp_ratio"],
                             num_classes=self.cfg["num_classes"],
                             learn_sigma=self.cfg["learn_sigma"])

    def weights_of(self, k, seed: int, device) -> Dict[str, torch.Tensor]:
        if self.dit:
            return ref_dit.make_weights(self.dit_sizes(k), seed, device)
        return make_weights(k, self.shape[2], seed, device)

    def load_weights(self, model: torch.nn.Module, k, seed: int, device) -> None:
        """The benchmark's seeded weights into ``model``: a DiT's drawn
        straight into its tensors (no second copy of a 675M-parameter
        model), a U-Net's loaded from :meth:`weights_of`."""
        if self.dit:
            params = dict(model.state_dict())
            params.pop("pos_embed", None)
            names = {n for n, _, _ in ref_dit.param_spec(self.dit_sizes(k))}
            if set(params) != names:
                raise RuntimeError(f"{k}: the program's model has other tensors than the "
                                   f"benchmark's ({sorted(set(params) ^ names)})")
            ref_dit.make_weights(self.dit_sizes(k), seed, device, into=params)
            return
        missing, unexpected = model.load_state_dict(self.weights_of(k, seed, device),
                                                    strict=False)
        if missing or unexpected:
            raise RuntimeError(f"{k}: the program's model has other tensors than the "
                               f"benchmark's ({missing}, {unexpected})")

    def flops(self) -> List[Dict[str, int]]:
        """Per-sample forward FLOPs of the teacher and each student."""
        h, w, c = self.shape
        out = []
        for k in [self.teacher_key, *self.keys]:
            if self.dit:
                s = self.dit_sizes(k)
                out.append(dit_forward_flops(s["depth"], s["hidden"], (h // s["patch"]) ** 2,
                                             s["patch"], c, s["out_channels"],
                                             self.cfg["mlp_ratio"]))
            else:
                out.append({"linear": forward_flops(k, h, w, c), "attention": 0})
        return out

    def forwards(self) -> int:
        """Forwards of one sample through one model in a call."""
        return sum(2 if g > 1.0 else 1 for g in self.scales) * (self.T - 1) * self.S

    def base_seed(self, k: int) -> int:
        return self.seed0 + k * self.S

    def call(self, k: int):
        job = {"students": self.students, "guidance_scales": self.scales,
               "num_samples": self.S, "base_seed": self.base_seed(k), "timesteps": self.T}
        res = self._sweep(self.teacher, [job], self.config, device=self.ctx.device,
                          verbose=False)[0]
        self.results[k] = res
        ok = all(math.isfinite(res[sk]["student_metrics"][gs]["endpoint_distance"])
                 for sk in self.keys for gs in self.scales)
        return self.S * len(self.scales) * len(self.keys), ok

    def slice(self) -> dict:
        self.call(WARM + 1)
        h, w, c = self.shape
        info = {"pairs": self.S * len(self.scales) * len(self.keys),
                "cfg_update_bytes": cfg_update_bytes(self.S * h * w * c, 4)}
        if self.dit:
            info["attention_flops"] = self.forwards() * sum(f["attention"] for f in self.flops())
            info["attention_bytes"] = self.forwards() * sum(
                attention_bytes(s["depth"], s["hidden"], (h // s["patch"]) ** 2)
                for s in map(self.dit_sizes, [self.teacher_key, *self.keys]))
        return info

    def release(self) -> None:
        del self.teacher, self.students, self._sweep
        self.results.pop(WARM, None)
        self.results.pop(WARM + 1, None)

    # -- the check -------------------------------------------------------------

    def check(self) -> List[tuple]:
        rng = np.random.default_rng(D.derive(self.ctx.seed, "check"))
        calls = sorted(self.results)
        k = calls[int(rng.integers(len(calls)))]
        chk = self.tr["check"]
        always = [float(g) for g in chk["scales_always"]]
        rest = [g for g in self.scales if g not in always]
        drawn = [float(g) for g in rng.choice(rest, int(chk["scales_drawn"]), replace=False)]
        key = (lambda x: str(x)) if self.dit else (lambda x: float(x))
        students = [key(s) for s in chk["students_always"]]
        others = [s for s in self.keys if s not in students]
        students += [others[int(i)] for i in
                     rng.choice(len(others), int(chk["students_drawn"]), replace=False)]
        scales = sorted(always + drawn)
        gaps = self.reference_gaps(k, scales, students)
        self.details = {"call": k, "scales": scales, "students": students, "gaps": gaps}
        worst = max(gaps.values())
        return [("sweep_metric_gap", float(worst), float(self.ctx.cell.limits["sweep_metric_gap"]))]

    def reference_model(self, w: Dict[str, torch.Tensor], k, labels):
        quant = ref_unet.fp8_quant if self.ctx.control == "reference_fp8" else None
        if self.dit:
            s = self.dit_sizes(k)
            pos = ref_dit.pos_embed(s["hidden"], s["input_size"] // s["patch"]).to(
                self.ctx.device)
            return lambda x, t, cond, mask: ref_dit.forward(w, x, t, cond, mask, labels, s,
                                                            pos=pos, quant=quant,
                                                            dtype=self.dtype)
        return lambda x, t, cond, mask: ref_unet.forward(w, x, t, cond, mask, k, quant=quant,
                                                         dtype=self.dtype)

    def reference_gaps(self, k: int, scales: List[float], students: list) -> Dict[str, float]:
        """The gap of every metric mean of call ``k`` at ``scales`` for
        ``students`` (absolute for the bounded scores, relative for the
        rest), by ``"metric@student@gs"``."""
        dev, S, T = self.ctx.device, self.S, self.T
        h, w, c = self.shape
        base = self.base_seed(k)
        seeds = [base + i for i in range(S)]
        alphas = linear_schedule(T, self.cfg["beta_start"], self.cfg["beta_end"])["alphas"]
        out: Dict[str, float] = {}
        with compare.float32_exact():
            noises = D.seeded_normal([(s, 0) for s in seeds], self.shape, dev)
            step_noise = D.step_noise(seeds, T, self.shape, dev)
            uniforms = (D.sweep_uniforms(base, S, T, h * w * c, dev)
                        if h * w * c > ref_metrics.SAMPLE_SIZE else None)
            labels = labels_of(seeds, self.cfg["num_classes"], dev) if self.dit else None
            weights = {sk: self.weights_of(sk, self.seeds[("student", sk)], dev)
                       for sk in students}
            teacher = self.reference_model(
                self.weights_of(self.teacher_key, self.seeds[("teacher", self.teacher_key)], dev),
                self.teacher_key, labels)
            for gs in scales:
                cfg_on = gs > 1.0
                t_traj = ref_chain.chain(teacher, noises, step_noise, alphas, T, cfg_on, gs)
                for sk in students:
                    model = self.reference_model(weights[sk], sk, labels)
                    s_traj = ref_chain.chain(model, noises, step_noise, alphas, T, cfg_on, gs)
                    ref = ref_metrics.scalar_metrics(t_traj, s_traj, uniforms)
                    got = self.results[k][sk]["student_metrics"][gs]
                    for name, vec in ref.items():
                        r = float(np.mean(vec.cpu().numpy()))
                        gap = (trajectory_mse_gap if name == "trajectory_mse" else
                               compare.absolute_gap if name in SCORES else compare.relative_gap)
                        out[f"{name}@{sk}@{gs}"] = gap(got[name], r)
                    del s_traj
                del t_traj
        return out


def setup(ctx) -> ModelsSweepRun:
    return ModelsSweepRun(ctx)
