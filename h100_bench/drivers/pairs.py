"""Paired teacher/student trajectories one sample at a time, as the
dimensionality and time-dependent analyses ask for them: one caller making
``TrajectoryManager.generate_trajectory(seed=k)`` calls back to back, each
returning both trajectories to the host.

The program draws each call's noise from its seed.  Set-up makes the
traffic's warm-up calls (the eager first call, the capture, a replay).
The check draws calls of the window from the seed, works out their noise,
runs the plain reference's chains at the configuration's precision and
compares each returned
trajectory with the reference's, against the path the reference moved from
the shared starting noise.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from h100_bench import program
from h100_bench.reference import chain as ref_chain
from h100_bench.reference import compare
from h100_bench.reference import unet as ref_unet
from h100_bench.yardstick import draws as D
from h100_bench.yardstick.flops import forward_flops
from h100_bench.yardstick.schedule import linear_schedule
from h100_bench.yardstick.weights import make_weights

WARM = 10 ** 6  # seeds of set-up's calls and the traced slice's, beyond any window


class PairsRun:
    def __init__(self, ctx):
        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.tr = ctx, cfg, tr
        self.T = int(tr["timesteps"])
        self.sf = float(tr["student_size_factor"])
        self.shape = (cfg["image_size"], cfg["image_size"], cfg["channels"])
        self.seed0 = D.derive(ctx.seed, "pairs") % 2 ** 30
        dev = ctx.device
        self.dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
        self.weights = {sf: make_weights(sf, cfg["channels"], D.derive(ctx.seed, f"weights/{sf}"),
                                         dev) for sf in (1.0, self.sf)}
        quant = "int8" if ctx.control == "program_int8" else "none"
        config = program.port_config(cfg, dev, ctx.workdir, timesteps=self.T, sampler_quant=quant)
        from distillation_trajectories_torch.trajectories.manager import TrajectoryManager

        self.manager = TrajectoryManager(
            program.port_unet(config, 1.0, self.weights[1.0], dev),
            program.port_unet(config, self.sf, self.weights[self.sf], dev),
            config, size_factor=self.sf, device=dev)
        self.out: Dict[int, tuple] = {}
        h, w, c = self.shape
        self.call_flops = (self.T - 1) * (forward_flops(1.0, h, w, c) + forward_flops(self.sf, h, w, c))
        for i in range(int(tr["warmup_calls"])):
            self.manager.generate_trajectory(seed=self.seed_of(WARM + i))

    def seed_of(self, k: int) -> int:
        return self.seed0 + k

    def call(self, k: int):
        teacher, student = self.manager.generate_trajectory(seed=self.seed_of(k))
        self.out[k] = (teacher, student)
        return 1, bool(np.isfinite(teacher).all() and np.isfinite(student).all())

    def slice(self) -> dict:
        n = int(self.tr["traced_calls"])
        for i in range(n):
            self.manager.generate_trajectory(seed=self.seed_of(2 * WARM + i))
        return {"pairs": n}

    def release(self) -> None:
        del self.manager

    def check(self) -> List[tuple]:
        rng = np.random.default_rng(D.derive(self.ctx.seed, "check"))
        calls = sorted(self.out)
        n = min(int(self.tr["check"]["calls"]), len(calls))
        picked = sorted(int(k) for k in rng.choice(calls, n, replace=False))
        gaps = self.reference_gaps(picked)
        self.details = {"calls": picked, "gaps": gaps}
        return [("pair_traj_gap", float(max(gaps.values())),
                 float(self.ctx.cell.limits["pair_traj_gap"]))]

    def reference_gaps(self, calls: List[int]) -> Dict[str, float]:
        dev, T = self.ctx.device, self.T
        alphas = linear_schedule(T, self.cfg["beta_start"], self.cfg["beta_end"])["alphas"]
        out: Dict[str, float] = {}
        with compare.float32_exact():
            for k in calls:
                seed = self.seed_of(k)
                noise = D.seeded_normal([(seed, 0)], self.shape, dev)
                step_noise = D.step_noise([seed], T, self.shape, dev)
                for i, sf in enumerate((1.0, self.sf)):
                    model = (lambda s: lambda x, t, cond, mask: ref_unet.forward(
                        self.weights[s], x, t, cond, mask, s, dtype=self.dtype))(sf)
                    ref = ref_chain.chain(model, noise, step_noise, alphas, T, False, 1.0)[0]
                    out[f"{'teacher' if i == 0 else 'student'}@{k}"] = compare.trajectory_gap(
                        self.out[k][i], ref.cpu().numpy())
        return out


def setup(ctx) -> PairsRun:
    return PairsRun(ctx)
