"""pq_fc_fused_roofline: the fused gather-decode GEMM (``ops/cuda/
pq_fc_fused.py``, ``csrc/pq_fc_fused.cu``) at the inner products of an
offline step: their least time over the kernel's traced time, in %."""

from bench_cuda.metrics._roofline import share


def read(ctx):
    return share(ctx, "pq_fc_fused")
