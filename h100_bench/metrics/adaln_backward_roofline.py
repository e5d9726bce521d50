"""The adaLN backward kernels' share of their roofline, in %: the byte bound
of every backward launch of the traced slice at the cell's shapes and
dtypes (``yardstick/adaln_bytes.py``: one DiT step's launches times the
steps, at the card's HBM bandwidth) over the summed device time of the
kernels named ``adaln_backward`` (the row kernel and its column-sum
reduction), so a launch's bound over its mean time."""

from h100_bench.yardstick.peaks import HBM_BYTES_PER_S

KERNEL = "adaln_backward"


def read(obs):
    trace = obs.trace
    nbytes = trace.info.get("adaln_backward_bytes")
    durations = trace.kernel_durations_ns(KERNEL)
    if not nbytes or not len(durations):
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (float(durations.sum()) / 1e9)
