"""Offline activation calibration for static-scale int8 execution.

Port of ``qcnn_tpu/models/calibrate.py``. One bf16 forward over a
calibration batch records amax(|input|) of every conv and FC
(``network.forward(collect_act_amax=True)``); ``act_scale = margin * amax /
127`` then goes into ``prepare_params(dtype=torch.int8, act_scales=...)``.
At run time activations quantize with that constant scale, and values past
the calibrated range clip.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from qcnn_tpu_torch.core import ModelSpec
from qcnn_tpu_torch.models import network


def calibrate_act_scales(
    spec: ModelSpec,
    params: Sequence[Optional[dict]],
    x_calib,
    *,
    conv_impls: Optional[tuple[str, ...]] = None,
    fc_impls: Optional[tuple[str, ...]] = None,
    margin: float = 1.0,
    device=None,
) -> dict[int, float]:
    """{layer_index: static activation scale} from one calibration batch.

    ``params`` must run in float (bf16/f32 prepared, or raw PQ): calibrate
    before the int8 preparation. device: None means "cuda"; pass "cpu" to
    calibrate with the plain versions."""
    _, amax = network.forward(
        params, x_calib, spec=spec, conv_impls=conv_impls, fc_impls=fc_impls,
        compute_dtype=torch.bfloat16, with_softmax=False,
        collect_act_amax=True, device=device)
    # floored at the dynamic path's epsilon: a layer whose calibration input
    # is all zeros must not get scale 0
    return {i: max(float(v), 1e-12) * margin / 127.0
            for i, v in amax.items()}
