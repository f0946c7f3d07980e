"""The parallel layer on ``torch.distributed``: data, tensor and pipeline
parallelism over a mesh of ranks.

Binds the names that ``qcnn_tpu/parallel/__init__.py`` exports."""

from qcnn_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
)
from qcnn_tpu_torch.parallel.sharding import (  # noqa: F401
    make_sharded_forward,
    param_shardings,
    shard_params,
)
from qcnn_tpu_torch.parallel.pipeline import (  # noqa: F401
    STAGE_AXIS,
    make_pipeline_mesh,
    pipeline_vit_forward,
    place_pipeline_params,
    stack_vit_blocks,
)
