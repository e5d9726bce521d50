"""The trajectory sweep as its users call it: one
``sweep_compare_trajectories_multi`` call per job, back to back.

Each call is one job: every student of the configuration, the traffic's
guidance scales and ``num_samples`` samples at ``timesteps`` steps, its
``base_seed`` from ``--seed`` and the call's index.  The program draws the
call's noise from that seed, as users' sweeps do, and builds its chain
makers anew inside each call.  Set-up makes one whole call.

The check draws one call of the window and some of its scales from the
seed, works out the same draws, runs the plain reference's chains at the
configuration's precision and the metric suite, and compares the metric means the program
returned with the reference's: the widest gap over metrics, students and
scales.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from h100_bench import program
from h100_bench.reference import chain as ref_chain
from h100_bench.reference import compare
from h100_bench.reference import metrics as ref_metrics
from h100_bench.reference import unet as ref_unet
from h100_bench.yardstick import draws as D
from h100_bench.yardstick.flops import cfg_update_bytes, forward_flops
from h100_bench.yardstick.schedule import linear_schedule
from h100_bench.yardstick.weights import make_weights

WARM = 10 ** 6  # index of set-up's call; the traced slice's is WARM + 1

# Scores of the suite bounded by construction (similarities, consistencies,
# exp(-k d) alignments): compared by their absolute gap.  An exponential or
# a square of a mean near zero multiplies a small relative error in the
# distances beneath it many times over, so a relative gap of such a score
# measures its conditioning, not the chain.  The rest are distances,
# lengths and ratios: compared by their relative gap.
SCORES = ("trajectory_mse", "point_by_point_similarity", "log_mse_similarity",
          "path_length_similarity", "efficiency_similarity", "mean_velocity_similarity",
          "mean_directional_consistency", "weighted_directional_consistency", "path_alignment",
          "distribution_similarity")


class SweepRun:
    def __init__(self, ctx):
        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.tr = ctx, cfg, tr
        self.S, self.T = int(tr["num_samples"]), int(tr["timesteps"])
        self.scales = [float(g) for g in tr["guidance_scales"]]
        self.sizes = [float(sf) for sf in cfg["student_size_factors"]]
        self.shape = (cfg["image_size"], cfg["image_size"], cfg["channels"])
        self.seed0 = D.derive(ctx.seed, "sweep") % 2 ** 30
        dev = ctx.device
        self.dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
        self.weights = {sf: make_weights(sf, cfg["channels"], D.derive(ctx.seed, f"weights/{sf}"),
                                         dev) for sf in (1.0, *self.sizes)}
        quant = "int8" if ctx.control == "program_int8" else "none"
        self.config = program.port_config(cfg, dev, ctx.workdir, timesteps=self.T,
                                          sampler_quant=quant)
        self.teacher = program.port_unet(self.config, 1.0, self.weights[1.0], dev)
        self.students = {sf: program.port_unet(self.config, sf, self.weights[sf], dev)
                         for sf in self.sizes}
        from distillation_trajectories_torch.trajectories.engine import (
            sweep_compare_trajectories_multi,
        )
        self._sweep = sweep_compare_trajectories_multi
        self.results: Dict[int, dict] = {}
        h, w, c = self.shape
        forwards = sum(2 if g > 1.0 else 1 for g in self.scales) * (self.T - 1) * self.S
        self.call_flops = forwards * sum(forward_flops(sf, h, w, c) for sf in (1.0, *self.sizes))
        self.call(WARM)

    def base_seed(self, k: int) -> int:
        return self.seed0 + k * self.S

    def call(self, k: int):
        job = {"students": self.students, "guidance_scales": self.scales,
               "num_samples": self.S, "base_seed": self.base_seed(k), "timesteps": self.T}
        res = self._sweep(self.teacher, [job], self.config, device=self.ctx.device,
                          verbose=False)[0]
        self.results[k] = res
        ok = all(math.isfinite(res[sf]["student_metrics"][gs]["endpoint_distance"])
                 for sf in self.sizes for gs in self.scales)
        return self.S * len(self.scales) * len(self.sizes), ok

    def slice(self) -> dict:
        self.call(WARM + 1)
        h, w, c = self.shape
        return {"pairs": self.S * len(self.scales) * len(self.sizes),
                "cfg_update_bytes": cfg_update_bytes(self.S * h * w * c, 4)}

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
        scales = sorted(always + drawn)
        gaps = self.reference_gaps(k, scales)
        self.details = {"call": k, "scales": scales, "gaps": gaps}
        worst = max(gaps.values())
        return [("sweep_metric_gap", float(worst), float(self.ctx.cell.limits["sweep_metric_gap"]))]

    def reference_gaps(self, k: int, scales: List[float]) -> Dict[str, float]:
        """The gap of every metric mean of call ``k`` at ``scales`` (absolute
        for the bounded scores, relative for the rest), by
        ``"metric@sf@gs"``."""
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

            def model(sf):
                return lambda x, t, cond, mask: ref_unet.forward(self.weights[sf], x, t, cond,
                                                                 mask, sf,
                                                                 dtype=self.dtype)

            for gs in scales:
                cfg_on = gs > 1.0
                teacher = ref_chain.chain(model(1.0), noises, step_noise, alphas, T, cfg_on, gs)
                for sf in self.sizes:
                    student = ref_chain.chain(model(sf), noises, step_noise, alphas, T, cfg_on, gs)
                    ref = ref_metrics.scalar_metrics(teacher, student, uniforms)
                    got = self.results[k][sf]["student_metrics"][gs]
                    for name, vec in ref.items():
                        r = float(np.mean(vec.cpu().numpy()))
                        gap = compare.absolute_gap if name in SCORES else compare.relative_gap
                        out[f"{name}@{sf}@{gs}"] = gap(got[name], r)
                    del student
                del teacher
        return out


def setup(ctx) -> SweepRun:
    return SweepRun(ctx)
