"""The DiT's attention kernels' share of their roofline, in %: the least
time the card could take for the traced slice's attention (the larger of
its FLOPs, ``4 N^2 d`` a block a forward-sample, over the bf16 dense peak,
and its bytes, q, k and v read and the output written once, over the HBM
bandwidth; at N = 256 the bytes bound it) over the summed device time of
the fused attention kernels the slice launched."""

from h100_bench.yardstick.kernel_names import is_attention
from h100_bench.yardstick.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def read(obs):
    trace = obs.trace
    flops, nbytes = trace.info.get("attention_flops"), trace.info.get("attention_bytes")
    sel = [i for i, n in enumerate(trace.kernel_names) if is_attention(n)]
    if not flops or not sel:
        return None
    seconds = float((trace.kernels[sel, 1] - trace.kernels[sel, 0]).sum()) / 1e9
    return 100.0 * max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) / seconds
