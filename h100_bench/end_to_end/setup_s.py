"""Process start to the first timed call: imports, weights, data, warm-up
and, in a checkout's first run, the kernels' compilation."""


def read(window):
    return window.setup_s
