"""The device's idle share over the traced sampler slice, in %:
1 - busy / window, busy the union of kernel, memcpy and memset spans, the
window less the profiler's own buffer handling (``yardstick/trace.py``)."""


def read(obs):
    trace = obs.trace
    if not trace.kernel_count():
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
