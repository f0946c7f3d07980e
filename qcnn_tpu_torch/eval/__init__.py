"""Classification facade and dataset evaluation (``qcnn_tpu/eval/``'s
harness, ported)."""

from qcnn_tpu_torch.eval.harness import (  # noqa: F401
    Classifier,
    ClassifyResult,
    FamilyClassifier,
    accuracy_at_k,
    evaluate_dataset,
)
