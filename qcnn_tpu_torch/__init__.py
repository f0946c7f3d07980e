"""qcnn_tpu_torch — the PyTorch + CUDA port of qcnn_tpu for NVIDIA Hopper.

A package beside ``qcnn_tpu`` (the JAX reference, which it never imports).
Entry points: ``models.prepare.prepare_params`` -> ``models.network.forward``,
and ``models.interop.params_from_jax`` for weights from the JAX package.
They run on the card unless the caller passes ``device="cpu"``. The PQ
kernels are hand-written CUDA in ``csrc/``, built on first use
(``ops/cuda/_build.py``).
"""
