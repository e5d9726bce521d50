"""The optimizer's share of the traced training slice's kernel time, in %:
the device time of the Adam update, zero-grad and EMA kernels
(``yardstick/optimizer_kernels.py``) over the summed time of every kernel."""

from h100_bench.yardstick.optimizer_kernels import is_optimizer


def read(obs):
    trace = obs.trace
    if not trace.kernel_count():
        return None
    durations = (trace.kernels[:, 1] - trace.kernels[:, 0]).tolist()
    opt = sum(ns for name, ns in zip(trace.kernel_names, durations) if is_optimizer(name))
    return 100.0 * opt / sum(durations) if opt else None
