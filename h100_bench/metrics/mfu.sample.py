"""The sampler's U-Net FLOPs (convolutions and linear layers of every
forward the window's chains made, counted from the shapes) over the
window's host-clock seconds and the card's bf16 dense peak, in %."""

from h100_bench.yardstick.peaks import BF16_FLOPS


def read(obs):
    w = obs.window
    if not obs.trace.kernel_count() or not sum(w.flops):
        return None  # a run that drove no device reads no device share
    return 100.0 * sum(w.flops) / sum(w.seconds) / BF16_FLOPS
