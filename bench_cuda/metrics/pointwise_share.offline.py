"""pointwise_share.offline: the share of an offline slice's device-busy time
spent under the program's pointwise spans, in %: ``qcnn.epilogue`` (each
product's bias, activation and residual, ``ops/fc.emit``), ``qcnn.relu``
and ``qcnn.residual``. None outside an offline cell, where the slice holds
no forward span, or where no kernel ran under those spans."""

from bench_cuda import spans


def read(ctx):
    return spans.kind_share(ctx, ("epilogue", "relu", "residual"))
