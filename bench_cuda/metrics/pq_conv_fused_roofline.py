"""pq_conv_fused_roofline: the fused decode-conv (``ops/cuda/
pq_conv_fused.py``, ``csrc/pq_conv_fused.cu``) at the stride-1 3x3 convs
that an offline step gives it: their least time over the kernel's traced
time, in %."""

from bench_cuda.metrics._roofline import share


def read(ctx):
    return share(ctx, "pq_conv_fused")
