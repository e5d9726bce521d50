"""Device kernel events per trajectory pair in the traced slice."""


def read(obs):
    trace = obs.trace
    pairs = trace.info.get("pairs")
    if not pairs or not trace.kernel_count():
        return None
    return trace.kernel_count() / pairs
