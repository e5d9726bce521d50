"""Kernel families by the names the device trace gives them on the H100:
PyTorch's fused attention kernels (flash, cuDNN, memory-efficient) and the
matrix products and convolutions (cuBLAS, cuBLASLt, CUTLASS, cuDNN)."""

ATTENTION = ("flash_fwd", "fmha", "sdpa", "attention")
MATMUL = ("gemm", "nvjet", "xmma", "cutlass", "wgmma", "cublas", "implicit_convolve")
CFG_UPDATE = "cfg_engine_update_kernel"


def is_attention(name: str) -> bool:
    return any(a in name for a in ATTENTION)


def is_matmul(name: str) -> bool:
    return not is_attention(name) and any(m in name for m in MATMUL)
