"""The share of the traced DiT slice's kernel time outside matrix products,
attention and the CFG update, in %: the LayerNorm, modulate, gate, GELU,
cast, copy and add kernels (and the slice's draws and metric suite), the
memory-bound part of the model step that a fused kernel would shrink.
Kernel time is the sum of the kernels' device durations."""

from h100_bench.yardstick.kernel_names import CFG_UPDATE, is_attention, is_matmul


def read(obs):
    trace = obs.trace
    if not trace.info.get("attention_flops") or not trace.kernel_count():
        return None
    durations = (trace.kernels[:, 1] - trace.kernels[:, 0]).tolist()
    other = sum(ns for name, ns in zip(trace.kernel_names, durations)
                if not (CFG_UPDATE in name or is_attention(name) or is_matmul(name)))
    return 100.0 * other / sum(durations)
