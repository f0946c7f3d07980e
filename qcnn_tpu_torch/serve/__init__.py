"""Serving: continuous-batching engine + HTTP front end (``qcnn_tpu/serve/``,
ported)."""

from qcnn_tpu_torch.serve.engine import (
    BatchingEngine, DeadlineExceeded, EngineConfig, EngineOverloaded,
)

__all__ = ["BatchingEngine", "DeadlineExceeded", "EngineConfig",
           "EngineOverloaded"]
