"""The ``sweep_models`` driver's cells (``dit-xl2-256.sweep-b32``,
``cifar10-32.cfg-cli-b10``): the faults their check must catch, their
controls, the DiT's FLOP count, and the DiT reference against the port,
its weights drawn into the port's tensors as the driver draws them."""

import pytest
import torch

from h100_bench import harness
from h100_bench.reference import dit as ref_dit
from h100_bench.tests.tiny import tiny_cell
from h100_bench.yardstick.dit_flops import attention_bytes, dit_forward_flops

DIT, CLI = "dit-xl2-256.sweep-b32", "cifar10-32.cfg-cli-b10"
SEED = 2 ** 31 + 2 ** 20 + 17


def _run(name, **kw):
    return harness.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu", **kw)


@pytest.mark.parametrize("fault", ["labels_dropped", "labels_shifted", "state_unchanged"])
def test_dit_faults_are_caught(monkeypatch, fault):
    from distillation_trajectories_torch.diffusion import sampling
    from distillation_trajectories_torch.models.dit import DiT
    from distillation_trajectories_torch.trajectories import engine

    if fault == "labels_dropped":  # every forward takes the null class
        monkeypatch.setattr(DiT, "classes", lambda self, c, m, labels, b, device: torch.full(
            (b,), self.num_classes, dtype=torch.int64, device=device))
    elif fault == "labels_shifted":  # each sample takes its neighbour's label
        orig = engine.sample_labels
        monkeypatch.setattr(engine, "sample_labels",
                            lambda seeds, n, device: orig(seeds, n, device).roll(1))
    else:
        monkeypatch.setattr(sampling, "cfg_engine_update_row",
                            lambda x, uncond, cond, noise, row: x.clone())
    assert _run(DIT)["correct"] is False


def test_cli_fault_is_caught(monkeypatch):
    from distillation_trajectories_torch.trajectories import engine

    orig = engine.batch_metrics_core

    def altered(*a, **k):
        out = orig(*a, **k)
        out["endpoint_distance"] = out["endpoint_distance"] * 1.05
        return out

    monkeypatch.setattr(engine, "batch_metrics_core", altered)
    assert _run(CLI)["correct"] is False


CONTROLS = [(DIT, "reference_fp8"), (CLI, "program_int8")]


@pytest.mark.parametrize("name, control", CONTROLS)
def test_controls_are_wired(name, control):
    sound = _run(name)["checks"]
    low = _run(name, control=control)["checks"]
    assert max(c["value"] / max(sound[k]["value"], 1e-12) for k, c in low.items()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("name, control", CONTROLS)
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 3, 7_000_001])
def test_controls_fail_on_the_card(card, name, control, seed):
    cell = harness.find_cell(harness.manifest(), name)
    assert harness.run_cell(cell, seed, 1.0, False, card, control=control)["correct"] is False


def test_dit_flops_by_hand():
    """DiT-XL/2 at 256 tokens: 237.2 GFLOP a forward (2 x the paper's
    118.6 GMACs), 3.6% of it in the attention products."""
    f = dit_forward_flops(28, 1152, 256)
    assert round(sum(f.values()) / 1e9, 1) == 237.2
    assert round(f["attention"] / sum(f.values()), 3) == 0.036
    assert f["attention"] == 28 * 4 * 256 ** 2 * 1152
    assert attention_bytes(28, 1152, 256) == 28 * 4 * 256 * 1152 * 2


def test_reference_matches_the_port():
    from distillation_trajectories_torch.models.dit import DiT

    s = ref_dit.sizes(2, 64, 4, input_size=8)
    w = ref_dit.make_weights(s, 5, "cpu")
    model = DiT(input_size=8, in_channels=4, depth=2, hidden_size=64, num_heads=4).eval()
    params = {k: v for k, v in model.state_dict().items() if k != "pos_embed"}
    ref_dit.make_weights(s, 5, "cpu", into=params)  # as the driver loads a DiT
    assert all(torch.equal(params[k], w[k]) for k in w)
    gen = torch.Generator().manual_seed(1)
    x, t = torch.randn((3, 8, 8, 4), generator=gen), torch.tensor([1.0, 20.0, 49.0])
    cond = mask = torch.ones((3, 1))
    labels = torch.tensor([0, 500, 999])
    with torch.no_grad():
        torch.testing.assert_close(model(x, t, cond, mask, labels),
                                   ref_dit.forward(w, x, t, cond, mask, labels, s),
                                   rtol=1e-5, atol=1e-5)
