"""window_attention_fused_roofline: the window attention kernel
(``ops/cuda/window_attention_fused.py``, ``csrc/window_attention_fused.cu``)
at the block and grid partitions of an offline step: their least time over
the kernel's traced time, in %."""

from bench_cuda.metrics._roofline import share


def read(ctx):
    return share(ctx, "window_attention_fused")
