"""Layer ops: dense and PQ convolution and FC, pooling, LRN, activations.

Public functions take the JAX package's layouts (NHWC activations, HWIO
kernels, (Cin, Cout) weights) so the two can be compared like for like."""

from qcnn_tpu_torch.ops.conv import conv_dense, pq_conv  # noqa: F401
from qcnn_tpu_torch.ops.fc import fc_dense, pq_fc  # noqa: F401
from qcnn_tpu_torch.ops.lut import (  # noqa: F401
    assignments_one_hot,
    build_lut,
    decode_conv_kernel,
    decode_fc_weight,
    pad_features,
)
from qcnn_tpu_torch.ops.misc import (  # noqa: F401
    caffe_max_pool,
    dropout_inference,
    lrn,
    relu,
    softmax,
)
