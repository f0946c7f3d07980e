"""Model specs, synthetic parameters, preparation and the forward pass.

Binds the names that ``qcnn_tpu/models/__init__.py`` exports: the zoo,
the forward pass and the reference loader."""

from qcnn_tpu_torch.models.zoo import (  # noqa: F401
    MODELS,
    alexnet,
    caffenet,
    caffenet_fgb,
    caffenet_fgd,
    get_model,
    vgg16,
    vgg_cnn_s,
)
from qcnn_tpu_torch.models.network import (  # noqa: F401
    forward,
    make_forward_fn,
    resolve_strategy,
    top_k_labels,
)
from qcnn_tpu_torch.models.loader import (  # noqa: F401
    LoadResult,
    load_alexnet_reference,
    load_class_names,
    load_image_labels,
    load_reference_model,
)
