"""dwconv_se_share.offline: the share of an offline slice's device-busy time
spent under MaxViT's depthwise-conv and squeeze-excite spans, in %:
``qcnn.dwconv`` (the 'same' pad and the depthwise conv) and ``qcnn.se``
(the mean, two FCs, the gate and the scale). None outside an offline cell,
where the slice holds no forward span, or where no kernel ran under those
spans."""

from bench_cuda import spans


def read(ctx):
    return spans.kind_share(ctx, ("dwconv", "se"))
