"""attention_share.offline: the share of an offline slice's device-busy time
spent under the program's attention spans, in %: ``qcnn.attention`` (the
attention kernel, Swin's bias) and ``qcnn.window`` (Swin's rolls to and
from the shifted grid). None outside an offline cell, where the slice holds
no forward span, or where no kernel ran under those spans."""

from bench_cuda import spans


def read(ctx):
    return spans.kind_share(ctx, ("attention", "window"))
