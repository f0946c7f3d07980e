"""Device and compute-dtype defaults for the port's entry points.

Every entry point (``prepare_params``, ``forward``, ``params_from_jax``)
takes ``device=None``, which means the card. With no CUDA device, the
caller has to ask for the CPU by name: nothing falls back to it silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (``qcnn_tpu/eval/harness.py``
    picks bf16 on the TPU and f32 elsewhere)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def iter_tensors(tree):
    """Every tensor in a tensor or a nested list / tuple / dict of them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_tensors(v)
