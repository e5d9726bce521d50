"""The fused CFG-update kernel's share of its roofline, in %: one launch's
byte bound at the chain's shapes and dtypes (four operands read once, the
state written once, its four scalars; at the card's HBM bandwidth) over
the mean device duration of the kernel's events in the traced slice."""

from h100_bench.yardstick.peaks import HBM_BYTES_PER_S

KERNEL = "cfg_engine_update_kernel"


def read(obs):
    trace = obs.trace
    nbytes = trace.info.get("cfg_update_bytes")
    durations = trace.kernel_durations_ns(KERNEL)
    if not nbytes or not len(durations):
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (durations.mean() / 1e9)
