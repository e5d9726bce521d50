"""Device kernel events per train step in the traced slice."""


def read(obs):
    trace = obs.trace
    steps = trace.info.get("steps")
    if not steps or not trace.kernel_count():
        return None
    return trace.kernel_count() / steps
