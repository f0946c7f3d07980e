"""The quantizer: sub-space k-means, plain / input-weighted /
error-corrected PQ and the OPQ permutation (``quantizer/sequential.py``
holds the whole-network passes). Port of ``qcnn_tpu/quantizer/``."""

from qcnn_tpu_torch.quantizer.kmeans import (  # noqa: F401
    KMeansResult,
    kmeans_step,
    subspace_kmeans,
)
from qcnn_tpu_torch.quantizer.pq import (  # noqa: F401
    PQResult,
    quantize_conv_layer,
    quantize_error_corrected,
    quantize_fc_layer,
    quantize_input_weighted,
    quantize_plain,
)
from qcnn_tpu_torch.quantizer.opq import (  # noqa: F401
    inverse_permutation,
    variance_permutation,
)
