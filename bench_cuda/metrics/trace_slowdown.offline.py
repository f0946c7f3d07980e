"""trace_slowdown.offline: what the profiler costs the steps it traces, in %:
100 x (1 - the traced slice's images/s / the untraced window's). The
slice's rate is its ``qcnn.forward`` spans x the batch / the slice. None
outside an offline cell or where the slice holds no forward span."""

from bench_cuda import spans


def read(ctx):
    return spans.slowdown(ctx)
