"""The teacher step's U-Net FLOPs (two train forwards a step, each counted
three times for forward and backward; convolutions and linear layers from
the shapes) of every epoch of the window over its host-clock seconds and
the card's bf16 dense peak, in %."""

from h100_bench.yardstick.peaks import BF16_FLOPS


def read(obs):
    w = obs.window
    if not obs.trace.kernel_count() or not sum(w.flops):
        return None  # a run that drove no device reads no device share
    return 100.0 * sum(w.flops) / sum(w.seconds) / BF16_FLOPS
