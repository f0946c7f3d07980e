"""Pooling, LRN, activations — the non-PQ layers of the 7-type op set.

Port of ``qcnn_tpu/ops/misc.py``. Activations are NHWC ``(B, H, W, C)`` at
every public function, as in the JAX package; the pool runs on the NCHW
view of the same memory (``permute(0, 3, 1, 2)`` of an NHWC tensor is a
``channels_last`` NCHW tensor, no copy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool_out(h: int, kernel: int, stride: int, pad: int,
              ceil_mode: bool) -> int:
    if not ceil_mode:
        return (h + 2 * pad - kernel) // stride + 1
    o = -(-(h + 2 * pad - kernel) // stride) + 1
    # Caffe's clamp (pooling_layer.cpp): drop a trailing output whose
    # window lies entirely in padding
    if pad and (o - 1) * stride >= h + pad:
        o -= 1
    return o


def caffe_max_pool(
    x: torch.Tensor, *, kernel: int, stride: int, pad: int = 0,
    ceil_mode: bool = True,
) -> torch.Tensor:
    """Max pooling with Caffe's CEIL output-size rule.

    out = ceil((H + 2p - k)/s) + 1 (CaffeEva.cc:367-370), minus a trailing
    window that lies entirely in padding; border windows are clamped to
    valid pixels (:885-898), which -inf padding reproduces exactly. The
    input is padded with -inf (``pad`` before, enough after for the last
    window) and pooled with the floor rule, as the JAX package's
    ``reduce_window`` does; ``ceil_mode=False`` gives the floor rule.

    int8 activation codes (the int8-native dataflow) pool as codes: max
    commutes with a monotone per-tensor quantization. They pool through
    their bf16 values, which hold every code exactly; every window holds a
    real pixel, so the -inf padding never wins and the result is the JAX
    package's pool with the dtype minimum as identity
    (qcnn_tpu/ops/misc.py:43-50).
    """
    if x.dtype == torch.int8:
        return caffe_max_pool(x.to(torch.bfloat16), kernel=kernel,
                              stride=stride, pad=pad,
                              ceil_mode=ceil_mode).to(torch.int8)
    if not torch.is_floating_point(x):
        raise ValueError(f"caffe_max_pool takes float values or int8 codes, "
                         f"got {x.dtype}")
    _, h, w, _ = x.shape
    oh = _pool_out(h, kernel, stride, pad, ceil_mode)
    ow = _pool_out(w, kernel, stride, pad, ceil_mode)
    pad_h_hi = max(0, (oh - 1) * stride + kernel - h - pad)
    pad_w_hi = max(0, (ow - 1) * stride + kernel - w - pad)
    xn = x.permute(0, 3, 1, 2)
    if pad or pad_h_hi or pad_w_hi:
        xn = F.pad(xn, (pad, pad_w_hi, pad, pad_h_hi), value=float("-inf"))
    return F.max_pool2d(xn, kernel, stride).permute(0, 2, 3, 1)


def lrn(
    x: torch.Tensor, *, size: int, alpha: float, beta: float, k: float,
    impl: str = "auto", channel_map=None, sum_dtype=None,
) -> torch.Tensor:
    """Across-channel local response normalization (CalcFeatMap_LoRN,
    CaffeEva.cc:1038-1089):

        out = x * (k + (alpha/size) * sum_{window} x^2) ** (-beta)

    with a channel window of ``size`` centred at each channel, zero-padded.

    impl: ``"jnp"`` sums ``size`` shifted slices of the f32 square;
    ``"band"`` squares in the input dtype and materialises the window sum
    as a banded ``c x c`` product in ``sum_dtype`` (f32 by default).
    ``"auto"`` takes the form :func:`lrn_route` picks: on a bf16 or f32
    CUDA tensor the ``lrn_fused`` kernel (``ops/cuda/lrn_fused.py``; the
    ``"band"`` function in one pass, its window summed in f32 whatever
    ``sum_dtype``), else ``"jnp"``. The JAX package's ``auto`` likewise
    squares in the input dtype on its accelerator (``"band"`` on a TPU).
    channel_map (lane-padded layouts, -1 = padding) forces ``"band"``.
    """
    if size % 2 == 0:
        # the band formulation is centred, the shifted-slice one is not:
        # for an even size they would disagree (qcnn_tpu/ops/misc.py)
        raise ValueError(f"lrn requires an odd window size, got {size}")
    radius = (size - 1) // 2
    if channel_map is not None:
        impl = "band"
    if impl == "auto":
        impl = lrn_route(x.device, x.dtype, size)
        if impl == "kernel":
            # imported here: ops/cuda/lrn_fused.py imports this module
            from qcnn_tpu_torch.ops.cuda.lrn_fused import lrn_fused

            return lrn_fused(x, size=size, alpha=alpha, beta=beta, k=k)
    if impl == "band":
        if channel_map is not None:
            m = torch.as_tensor(channel_map, device=x.device)
        else:
            m = torch.arange(x.shape[-1], device=x.device)
        valid = m >= 0
        band = ((m[:, None] - m[None, :]).abs() <= radius) & valid[:, None] \
            & valid[None, :]
        sq = x * x
        sum_dtype = sum_dtype or torch.float32
        if sum_dtype == sq.dtype:
            sq_sum = torch.matmul(sq, band.to(sq.dtype))
        else:
            # 0/1 band: products are exact, the sum accumulates in f32
            sq_sum = torch.matmul(sq.float(), band.float()).to(sum_dtype)
        scale = k + (alpha / size) * sq_sum.float()
        return (x.float() * _neg_pow(scale, beta)).to(x.dtype)
    if impl != "jnp":
        raise ValueError(f"unknown lrn impl: {impl!r}")
    xf = x.float()
    sq = xf * xf
    padded = F.pad(sq, (radius, size - 1 - radius))
    c = x.shape[-1]
    sq_sum = padded[..., :c]
    for off in range(1, size):
        sq_sum = sq_sum + padded[..., off:off + c]
    scale = k + (alpha / size) * sq_sum
    return (xf * _neg_pow(scale, beta)).to(x.dtype)


def lrn_route(device: torch.device, dtype: torch.dtype, size: int) -> str:
    """The form ``lrn(impl="auto")`` takes without a channel_map:
    ``"kernel"`` (``lrn_fused``) for an odd window over a bf16 or f32 CUDA
    tensor, else ``"jnp"`` (the CPU, other dtypes)."""
    if (device.type == "cuda" and dtype in (torch.bfloat16, torch.float32)
            and size % 2):
        return "kernel"
    return "jnp"


def _neg_pow(scale: torch.Tensor, beta: float) -> torch.Tensor:
    """scale ** (-beta), by rsqrt for the betas CNNs use (as the JAX
    package composes it, so both round alike)."""
    if beta == 0.75:
        r = torch.rsqrt(scale)
        return r * torch.sqrt(r)
    if beta == 0.5:
        return torch.rsqrt(scale)
    if beta == 1.0:
        return 1.0 / scale
    return torch.pow(scale, -beta)


def relu(x: torch.Tensor) -> torch.Tensor:
    """Dtype-preserving ReLU (integer codes stay integer)."""
    return torch.clamp_min(x, 0)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Numerically stable softmax (the reference's is unstabilised,
    CaffeEva.cc:1098-1116; max-subtraction is mathematically identical)."""
    return torch.softmax(x, dim=axis)


def dropout_inference(x: torch.Tensor) -> torch.Tensor:
    """Identity at test time (CalcFeatMap_Drpt, CaffeEva.cc:1091-1096)."""
    return x
