"""Host-side image preprocessing (copies of ``qcnn_tpu/preproc/``)."""

from qcnn_tpu_torch.preproc.bmp import (  # noqa: F401
    decode_image,
    encode_bmp24,
    read_bmp,
    read_image,
)
from qcnn_tpu_torch.preproc.pipeline import (  # noqa: F401
    MeanType,
    Preprocessor,
    ReszType,
    TorchPreprocessor,
    center_crop,
    resize_bilinear,
    resize_bilinear_halfpixel,
)
