"""The yardstick's FLOP and byte counts against the shapes and the port."""

import pytest
import torch

from h100_bench.yardstick.flops import cfg_update_bytes, unet_forward_flops


@pytest.mark.parametrize("sf, hw, channels, gflop", [
    (1.0, 32, 3, 1.6937), (0.5, 32, 3, 0.4256), (0.1, 32, 3, 0.0274), (1.0, 16, 1, 0.4220)])
def test_conv_flops_per_image(sf, hw, channels, gflop):
    assert unet_forward_flops(sf, hw, hw, channels)["conv"] / 1e9 == pytest.approx(gflop, abs=5e-5)


def test_linear_flops_at_full_size():
    # time MLP 2*256*256, cond MLP 2*1*256 + 2*256*256, one time projection a
    # block onto its 128/256/256/256/256/256/256/128 channels.
    expected = 2 * 256 * 256 * 2 + 2 * 256 + 2 * 256 * (128 + 256 * 6 + 128)
    assert unet_forward_flops(1.0, 32, 32, 3)["linear"] == expected == 1_180_160


@pytest.mark.parametrize("sf, hw, channels", [(1.0, 32, 3), (0.5, 32, 3), (1.0, 16, 1)])
def test_conv_flops_match_the_ports_hook_count(sf, hw, channels):
    from distillation_trajectories_torch.models.unet import DiffusionUNet
    from distillation_trajectories_torch.utils.profiling import conv_flops

    model = DiffusionUNet(channels=channels, size_factor=sf).eval()
    counted = conv_flops(model, torch.zeros(1, hw, hw, channels), torch.zeros(1))
    assert unet_forward_flops(sf, hw, hw, channels)["conv"] == counted


def test_cfg_update_bytes_by_hand():
    # [256, 32, 32, 3] float32: x, u, c, n read and out written, plus the
    # [4] float32 scalar row: 5 * 786,432 * 4 + 16 bytes.
    assert cfg_update_bytes(256 * 32 * 32 * 3, 4) == 15_728_656
    assert cfg_update_bytes(10, 2) == 5 * 10 * 2 + 16


@pytest.mark.parametrize("flush, own_idle", [((30, 50), 20), ((15, 35), 15), ((62, 68), 0)])
def test_trace_window_leaves_out_the_profilers_own_idle(flush, own_idle):
    import numpy as np

    from h100_bench.yardstick.trace import Trace

    spans = lambda *s: np.asarray(s, dtype=np.int64).reshape(-1, 2)
    trace = Trace((0, 100), ["k0", "k1"], spans((10, 20), (60, 70)), spans(),
                  ["cudaLaunchKernel", "Buffer Flush"], spans((5, 8), flush))
    assert trace.busy_s() == pytest.approx(20e-9)
    assert trace.window_s == pytest.approx((100 - own_idle) * 1e-9)
    assert trace.profiler_idle_s() == pytest.approx(own_idle * 1e-9)
    gaps = dict(trace.top_idle_gaps())
    assert "Buffer Flush" not in gaps
    assert sum(gaps.values()) == pytest.approx((80 - own_idle) * 1e-9)

