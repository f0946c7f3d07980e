"""host_wait_share.offline: the share of an offline slice in which the device
waited for the host, in %: the idle gaps that a launch started after the gap
began, over the slice. A gap whose next kernel was queued before it began
is the device's own and is not counted. None outside an offline cell or
where the slice holds no forward span."""

from bench_cuda import spans


def read(ctx):
    return spans.host_wait_share(ctx)
