"""Convolution ops: dense and PQ paths.

Port of ``qcnn_tpu/ops/conv.py``. Reference semantics: CalcFeatMap_ConvPrec
(CaffeEva.cc:681-758, per-group im2col + sgemm) and CalcFeatMap_ConvAprx
(:760-868). Output size floor((H + 2p - k)/s) + 1 (:361-362).

Activations are NHWC ``(B, H, W, C)`` at the public functions, as in the
JAX package. The convolution itself runs on the NCHW view of the same
memory (``channels_last``), and a kernel whose memory is OHWI — as every
decode of the port writes it — is a ``channels_last`` OIHW weight: neither
side is copied.

Strategy names keep the JAX vocabulary. Every in-step decode (``indecode``,
``indecode_ohwi``, ``indecode_hwoi``, ``gdecode``, ``gdecode_iohw``) runs the
``pq_decode`` kernel and differs only in the logical layout it hands to
``conv_dense``: the JAX package's one-hot decodes give the same bits as its
gather (qcnn_tpu/ops/lut.py:107-111) and only work around a slow TPU
gather. ``decode`` is the plain PyTorch gather. ``fusedconv`` runs the
``pq_conv_fused`` kernel, ``fc1x1`` the ``pq_fc_fused`` kernel over the
flattened pixels, and ``memory_fused`` picks one of them or the OHWI decode
per layer (:func:`memory_fused_route`). ``gemm`` decodes the weight with the
``pq_decode`` kernel in the FC layout and multiplies the im2col patches by
it (:func:`pq_conv_gemm`); ``memory`` picks ``gemm`` or the OHWI decode by
the JAX package's crossover (:func:`_gemm_wins`); ``lut`` is the reference's
LUT formulation as one convolution of the LUT with the one-hot assignments
(:func:`pq_conv_lut`).

Float32 convolutions run with TF32 off, whatever the caller's global
setting: cuDNN's default would round f32 operands to TF32.

The forwards reach a conv through :func:`conv_layer`, the one place that
reads a layer dict's format: PQ, int8 or dense. Its ``act`` and
``residual`` (a ReLU, a shortcut) join the bias in the product's one
epilogue (``ops.fc.emit``). Its ``pad`` may be a (before, after) pair, as
TensorFlow's 'same' padding gives a stride-2 conv on an even map
(:func:`same_pad`): an uneven pair pads the input with zeros first. :func:`instep_decodes` decodes a group of
convs and FCs in one ``pq_decode`` launch.

The int8 conv (:func:`conv_dense_int8`) has no library convolution on the
card (cuDNN takes no int8 conv through torch, and ``F.unfold`` no int8), so
it is an im2col of the int8 codes, copied once, and the shared int8 GEMM
(``ops.fc.int8_matmul``) once per group, as the JAX package leaves its
int8 ``conv_general_dilated`` to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qcnn_tpu_torch.ops import lut as lut_ops
from qcnn_tpu_torch.ops.cuda import (
    epilogue_fused,
    pq_conv_fused,
    pq_decode,
    pq_fc_fused,
)
from qcnn_tpu_torch.ops.fc import (
    INT_MM_MIN_ROWS,
    check_gdecode_codewords,
    emit,
    int8_matmul,
    matmul,
    pad_k_columns,
    padded_k,
    quantize_activations_int8,
    requantize_int8,
)
from qcnn_tpu_torch.utils.spans import NO_SPAN, span

# memory_fused's 1x1 reroute gates, copied from the JAX package
# (qcnn_tpu/ops/conv.py:30-41). _FC1X1_MAX_ROWS = 0 keeps the reroute off,
# as there: the rule was measured on a TPU (re-deriving it on the H100 is
# queued in ROADMAP.md A7b). The explicit impl "fc1x1" stays available.
_FC1X1_MIN_RATIO = 4
_FC1X1_MAX_ROWS = 0

# in-step decode impl -> the logical kernel layout it hands to conv_dense
_INSTEP_LAYOUTS = {
    "indecode": "hwio",
    "gdecode": "hwio",
    "indecode_ohwi": "ohwi",
    "indecode_hwoi": "hwoi",
    "gdecode_iohw": "iohw",
}
_IMPLS = ("decode", "fusedconv", "memory_fused", "fc1x1", "gemm", "memory",
          "lut", *_INSTEP_LAYOUTS)


def same_pad(kernel: int, stride: int, size: int):
    """TensorFlow's 'same' padding of one axis of ``size`` for a conv of
    ``kernel`` taps and ``stride`` (ceil(size / stride) outputs): the pad
    of both sides as an int where they agree, else (before, after), the
    odd pixel after (a 3x3 stride-2 conv on an even map: (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    lo = total // 2
    return lo if total - lo == lo else (lo, total - lo)


def memory_fused_route(params: dict, x_shape, x_dtype, *, stride: int,
                       pad: int, groups: int = 1) -> str:
    """The impl that ``pq_conv(impl="memory_fused")`` runs for one conv
    geometry, by the JAX package's rule (qcnn_tpu/ops/conv.py:44-86):
    'fusedconv' for bf16 stride-1 ungrouped square multi-tap convs with
    cin >= 256 whose one-image grid fits the TPU kernel's VMEM budget;
    'fc1x1' for qualifying 1x1 reductions (off: _FC1X1_MAX_ROWS = 0);
    'indecode_ohwi' otherwise, including every float32 caller."""
    b, h, w, cin = x_shape
    if x_dtype != torch.bfloat16:
        # both fused kernels compute with bf16 activations; f32 callers
        # keep the f32-exact decode
        return "indecode_ohwi"
    a_shape = params["assignments"].shape
    multi_tap = a_shape[1] > 1
    if (multi_tap and pq_conv_fused.supports(params, stride=stride,
                                             groups=groups, cin=cin)
            and pq_conv_fused.fits_vmem(h, w, pad, a_shape[1], a_shape[2])):
        return "fusedconv"
    cout = a_shape[0]
    # fc1x1 slices x[:, ::stride] first: ceil(h/stride) rows
    rows = b * (-(-h // stride)) * (-(-w // stride))
    k_cnt = params["codebooks"].shape[1]
    if (a_shape[1] == 1 and a_shape[2] == 1 and groups == 1 and pad == 0
            and cin >= _FC1X1_MIN_RATIO * cout
            and rows <= _FC1X1_MAX_ROWS
            and k_cnt <= pq_fc_fused.MAX_CODEWORDS):
        return "fc1x1"
    return "indecode_ohwi"


def _space_to_depth_transform(x: torch.Tensor, kernel: torch.Tensor,
                              stride: int):
    """Rewrite a strided small-Cin conv as a stride-1 conv on a
    space-to-depth input (qcnn_tpu/ops/conv.py:91-125): folding r x r
    spatial blocks into channels (r = stride) gives an equivalent stride-1
    conv over r*r*Cin channels, whose kernel over blocks holds the original
    weights at (t // r, t % r) and zeros elsewhere.

    Exact for pad == 0 (AlexNet conv1). x NHWC, kernel HWIO. Returns
    (x_sd, kernel_sd)."""
    b, h, w, cin = x.shape
    kh, kw, _, cout = kernel.shape
    r = stride
    kb = (kh - 1) // r + 1  # block-kernel size
    # pad H/W up to a multiple of r; padded pixels only fall in zero weight
    # slots (tap index >= kh) or beyond the last output's receptive field
    hp = -(-h // r) * r
    wp = -(-w // r) * r
    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x_sd = (x.reshape(b, hp // r, r, wp // r, r, cin)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, hp // r, wp // r, r * r * cin))
    # k_sd[bi, bj, (pi, pj, c), o] = k[r*bi+pi, r*bj+pj, c, o], zero past kh
    k_pad = F.pad(kernel, (0, 0, 0, 0, 0, kb * r - kw, 0, kb * r - kh))
    k_sd = (k_pad.reshape(kb, r, kb, r, cin, cout)
            .permute(0, 2, 1, 3, 4, 5)
            .reshape(kb, kb, r * r * cin, cout))
    return x_sd, k_sd


def conv_dense(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    *,
    stride: int,
    pad: int,
    groups: int = 1,
    space_to_depth: bool = False,
    kernel_layout: str = "HWIO",
    out_dtype=None,
    act=None,
    residual=None,
) -> torch.Tensor:
    """x: (B,H,W,Cin), kernel (kh,kw,Cin/groups,Cout) -> (B,Ho,Wo,Cout).

    Computes in the kernel's dtype with float32 accumulation, emitted in
    ``out_dtype`` (float32 when None), in which the bias is added — as the
    JAX package's ``preferred_element_type=out_dtype`` — then ``residual``
    (B,Ho,Wo,Cout) and ``act`` (``ops.fc.emit``).

    kernel_layout: any permutation of "HWIO" naming the kernel's axes.
    space_to_depth=True rewrites a strided small-Cin stem conv (HWIO
    kernel, pad 0, ungrouped, Cin <= 4, kernel wider than the stride) with
    :func:`_space_to_depth_transform`, as the JAX package's opt-in does;
    any other conv runs as it is.
    """
    if x.dtype == torch.int8:
        # int8 activations are quantized codes (qcnn_tpu/ops/conv.py:164-171)
        raise ValueError(
            "conv_dense received int8 activation codes; the consumer "
            "must be conv_dense_int8 or the producer must not requantize"
        )
    layout = kernel_layout.upper()
    if sorted(layout) != sorted("HWIO"):
        raise ValueError(f"kernel_layout must permute 'HWIO', got "
                         f"{kernel_layout!r}")
    if x.dtype != kernel.dtype:
        x = x.to(kernel.dtype)
    out_hw = None
    if (space_to_depth and layout == "HWIO" and pad == 0 and stride > 1
            and groups == 1 and x.shape[-1] <= 4
            and kernel.shape[0] > stride):
        # the output size of the ORIGINAL conv (floor rule,
        # CaffeEva.cc:361-362): the stride-1 conv can produce extra
        # trailing rows/cols when (H - k) % stride != 0
        out_hw = ((x.shape[1] - kernel.shape[0]) // stride + 1,
                  (x.shape[2] - kernel.shape[1]) // stride + 1)
        x, kernel = _space_to_depth_transform(x, kernel, stride)
        stride = 1
    w = kernel.permute(*(layout.index(c) for c in "OIHW"))
    xn = x.permute(0, 3, 1, 2)
    out_dtype = out_dtype or torch.float32
    if out_dtype == kernel.dtype and kernel.dtype != torch.float32:
        y = F.conv2d(xn, w, stride=stride, padding=pad, groups=groups)
    else:
        # widen exactly, sum in f32 without TF32, round once
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            y = F.conv2d(xn.float(), w.float(), stride=stride, padding=pad,
                         groups=groups)
    if out_hw is not None:
        y = y[:, :, :out_hw[0], :out_hw[1]]
    return emit(y.permute(0, 2, 3, 1), out_dtype, bias=bias, act=act,
                residual=residual)


def int8_kernel_matrix(kernel_q: torch.Tensor) -> torch.Tensor:
    """The (K, Cout) operand of the int8 GEMM for an HWIO int8 kernel, K in
    (kh, kw, Cg) order: a view when the kernel's memory is OHWI, as
    ``models.prepare`` holds it (its rows may be padded for the GEMM), a
    copy otherwise."""
    kh, kw, cg, cout = kernel_q.shape
    ohwi = kernel_q.permute(3, 0, 1, 2)
    k = kh * kw * cg
    row = ohwi.stride(0)
    if ohwi.stride()[1:] == (kw * cg, cg, 1) and row >= k:
        return ohwi.as_strided((k, cout), (1, row))
    return ohwi.reshape(cout, k).t()


def im2col_int8(xq: torch.Tensor, kh: int, kw: int, *, stride: int,
                pad: int, groups: int, k_pad: int
                ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(groups, rows, k_pad) int8 patches of NHWC codes and the output's
    (B, Ho, Wo). Each row's taps are in (kh, kw, Cg) order, zero past K =
    kh*kw*Cg and past the B*Ho*Wo real rows (rows = max(B*Ho*Wo,
    INT_MM_MIN_ROWS): the int8 GEMM's smallest operands,
    ``ops.fc.int8_matmul``). Built from ``Tensor.unfold`` views and copied
    once."""
    b, h, w, c = xq.shape
    cg = c // groups
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    k = kh * kw * cg
    m = b * ho * wo
    rows = max(m, INT_MM_MIN_ROWS)
    # (B, Ho, Wo, C, kh, kw) -> (G, B, Ho, Wo, kh, kw, Cg)
    patches = xq.unfold(1, kh, stride).unfold(2, kw, stride)
    patches = patches.reshape(b, ho, wo, groups, cg, kh, kw).permute(
        3, 0, 1, 2, 5, 6, 4)
    out = torch.empty((groups, rows, k_pad), dtype=torch.int8,
                      device=xq.device)
    if k_pad > k:
        out[:, :, k:].zero_()
    if rows > m:
        out[:, m:, :].zero_()
    out[:, :m, :k].view(groups, b, ho, wo, kh, kw, cg).copy_(patches)
    return out, (b, ho, wo)


def conv_int8_sums(xq: torch.Tensor, kernel_q: torch.Tensor, *, stride: int,
                   pad: int, groups: int = 1) -> torch.Tensor:
    """int32 sums of an int8 conv: NHWC int8 codes, an HWIO int8 kernel ->
    (B, Ho, Wo, Cout) int32. im2col, then one int8 GEMM a group."""
    kh, kw, cg, cout = kernel_q.shape
    wmat = int8_kernel_matrix(kernel_q)
    k_pad = padded_k(kh * kw * cg)
    cols, (b, ho, wo) = im2col_int8(xq, kh, kw, stride=stride, pad=pad,
                                    groups=groups, k_pad=k_pad)
    m = b * ho * wo
    step = cout // groups
    accs = [int8_matmul(cols[g],
                        pad_k_columns(wmat[:, g * step:(g + 1) * step],
                                      k_pad))[:m]
            for g in range(groups)]
    acc = accs[0] if groups == 1 else torch.cat(accs, dim=1)
    return acc.reshape(b, ho, wo, cout)


def conv_int8_sums_plain(xq: torch.Tensor, kernel_q: torch.Tensor, *,
                         stride: int, pad: int, groups: int = 1
                         ) -> torch.Tensor:
    """:func:`conv_int8_sums` as one float64 convolution: exact (every sum
    is an integer below 2^53), and a yardstick of the im2col path."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                 kernel_q.permute(3, 2, 0, 1).double(), stride=stride,
                 padding=pad, groups=groups)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def conv_dense_int8(x: torch.Tensor, kernel_q: torch.Tensor,
                    k_scale: torch.Tensor, bias: torch.Tensor, *, stride: int,
                    pad: int, groups: int = 1, act_scale=None,
                    out_scale=None) -> torch.Tensor:
    """int8 conv: kernel_q (kh, kw, Cg, Cout) int8 with per-Cout scales;
    activations quantized with a static or dynamic scale
    (``ops.fc.quantize_activations_int8``). Returns float32 values, or
    with out_scale int8 codes in the consumer's calibrated scale
    (``ops.fc.requantize_int8``, the int8-native dataflow)
    (qcnn_tpu/ops/conv.py:206-236)."""
    xq, x_scale = quantize_activations_int8(x, act_scale)
    acc = conv_int8_sums(xq, kernel_q, stride=stride, pad=pad, groups=groups)
    with span("epilogue"):
        if out_scale is not None:
            return requantize_int8(acc, x_scale, k_scale, bias, out_scale)
        return acc.float() * (x_scale * k_scale) + bias


def pq_conv_decode(
    x: torch.Tensor, params: dict, *, stride: int, pad: int, groups: int = 1,
    layout: str | None = None, out_dtype=None,
    decoded: torch.Tensor | None = None, act=None, residual=None,
) -> torch.Tensor:
    """PQ conv via a kernel decode + dense conv. layout=None decodes with
    the plain gather (HWIO); a layout name ('hwio', 'ohwi', 'hwoi', 'iohw')
    decodes with the ``pq_decode`` kernel and hands that logical layout on.
    decoded: this layer's (Cout, kh, kw, Cg) buffer from a grouped decode
    (``pq_decode.decode_conv_kernels_many``), taken in place of a launch of
    its own."""
    cg = x.shape[-1] // groups
    if layout is None:
        kernel = lut_ops.decode_conv_kernel(
            params["codebooks"], params["assignments"], cg)
        layout = "hwio"
    elif decoded is not None:
        kernel = pq_decode.conv_kernel_view(decoded, layout)
    else:
        kernel = pq_decode.decode_conv_kernel_gather(
            params["codebooks"], params["assignments"], cg, layout=layout)
    return conv_dense(
        x, kernel, params["bias"], stride=stride, pad=pad, groups=groups,
        kernel_layout=layout.upper(), out_dtype=out_dtype, act=act,
        residual=residual,
    )


def _gemm_wins(x_shape, cout: int, kh: int, kw: int, groups: int,
               stride: int, pad: int) -> bool:
    """The 'memory' impl's crossover, copied from the JAX package
    (qcnn_tpu/ops/conv.py:289-305): the im2col GEMM when the weight's
    elements x 50 exceed the patches' elements, never for 1x1 or grouped
    convs. The rule was measured on a TPU (re-deriving it on the H100 is
    queued in ROADMAP.md A7b)."""
    if kh == 1 and kw == 1:
        return False
    if groups != 1:
        return False
    b, h, w, cin = x_shape
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    weight_elems = kh * kw * cin * cout
    patch_elems = b * ho * wo * cin * kh * kw
    return weight_elems * 50 > patch_elems


def pq_conv_gemm(x: torch.Tensor, params: dict, *, stride: int, pad: int,
                 groups: int = 1, out_dtype=None, act=None,
                 residual=None) -> torch.Tensor:
    """In-step decode + im2col GEMM (qcnn_tpu/ops/conv.py:308-361).

      patches (B*Ho*Wo, Cin*kh*kw)  [F.unfold on the NCHW view: feature
                                     order (C, kh, kw), the order of
                                     lax.conv_general_dilated_patches]
      weight  (Cin*kh*kw, Cout)     [the ``pq_decode`` kernel in the FC
                                     layout, assignment rows packed
                                     (kh, kw, Cout): columns line up with
                                     the (c, ij) patch features]

    Every K <= 256 decodes with the kernel (the JAX package's one-hot
    decode past K = 128 gives the same bits). One matmul follows, float32
    sums without TF32 for float32 operands (``ops.fc.matmul``)."""
    if groups != 1:
        raise ValueError("pq_conv_gemm supports groups == 1")
    cb = params["codebooks"]
    a = params["assignments"]
    s = cb.shape[0]
    cout, kh, kw, _ = a.shape
    b, h, w_, cg = x.shape
    a2 = a.permute(1, 2, 0, 3).reshape(kh * kw * cout, s)
    w = pq_decode.decode_fc_weight_gather(cb, a2, cg)  # (Cin, kh*kw*Cout)
    w2 = w.reshape(cg * kh * kw, cout)
    patches = F.unfold(x.permute(0, 3, 1, 2).to(w2.dtype), (kh, kw),
                       padding=pad, stride=stride)     # (B, F, Ho*Wo)
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w_ + 2 * pad - kw) // stride + 1
    out = matmul(patches.transpose(1, 2).reshape(b * ho * wo, -1), w2,
                 out_dtype)
    return emit(out.reshape(b, ho, wo, cout), out.dtype, bias=params["bias"],
                act=act, residual=residual)


def pq_conv_lut(x: torch.Tensor, params: dict, *, stride: int, pad: int,
                groups: int = 1, out_dtype=None, act=None,
                residual=None) -> torch.Tensor:
    """PQ conv as LUT build + one-hot conv over the LUT channels
    (qcnn_tpu/ops/conv.py:364-408).

    Per group g: lut_g[b,h,w,s,k] = <x_g[b,h,w,s*D:(s+1)*D], C[s,k]>; then
    out[b,ho,wo,o] = bias[o] + sum_{kh,kw,s} lut_g[b, hi, wi, s, A[o,kh,kw,s]]
    which is a conv of lut_g (S*K channels) with the one-hot kernel
    OH[o,kh,kw,(s,k)] = [A[o,kh,kw,s] == k]. Zero padding of the LUT replays
    the reference's skipping of out-of-bounds kernel positions
    (CaffeEva.cc:820-827). The LUT and the one-hot kernel are float32."""
    codebooks = params["codebooks"]
    assignments = params["assignments"]  # (Cout, kh, kw, S)
    s, k, _ = codebooks.shape
    cout, kh, kw, _ = assignments.shape
    b, h, w, cin = x.shape
    cg = cin // groups
    luts = [lut_ops.build_lut(x[..., g * cg:(g + 1) * cg], codebooks)
            .reshape(b, h, w, s * k) for g in range(groups)]
    lut_all = torch.cat(luts, dim=-1) if groups > 1 else luts[0]
    onehot = lut_ops.assignments_one_hot(assignments, k).reshape(
        cout, kh, kw, s * k)
    return conv_dense(lut_all, onehot, params["bias"], stride=stride,
                      pad=pad, groups=groups, kernel_layout="OHWI",
                      out_dtype=out_dtype, act=act, residual=residual)


def _pq_conv_fc1x1(x: torch.Tensor, params: dict, *, stride: int, pad: int,
                   groups: int, out_dtype, act=None,
                   residual=None) -> torch.Tensor:
    """A 1x1 conv as an FC over the flattened pixels, through the
    ``pq_fc_fused`` kernel (decode name "gather"); the stride is a slice of
    x, exact for a 1x1 kernel with pad 0."""
    a = params["assignments"]
    if a.shape[1] != 1 or a.shape[2] != 1 or groups != 1 or pad != 0:
        raise ValueError(
            "fc1x1 requires an ungrouped 1x1 kernel with pad 0; got "
            f"taps {a.shape[1]}x{a.shape[2]}, groups={groups}, pad={pad}")
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    b, h, w, cin = x.shape
    fc_p = {"codebooks": params["codebooks"],
            "assignments": a.reshape(a.shape[0], a.shape[3]),
            "bias": params["bias"]}
    y = pq_fc_fused.pq_fc_fused(x.reshape(b * h * w, cin), fc_p,
                                decode="gather").reshape(b, h, w, -1)
    return emit(y, out_dtype, act=act, residual=residual)


def pq_conv(
    x: torch.Tensor,
    params: dict,
    *,
    stride: int,
    pad: int,
    groups: int = 1,
    impl: str = "decode",
    out_dtype=None,
    decoded: torch.Tensor | None = None,
    act=None,
    residual=None,
) -> torch.Tensor:
    """PQ conv by strategy name (see the module docstring), emitted in
    ``out_dtype`` with ``residual`` and ``act`` after the bias. decoded:
    the layer's weight from a grouped decode, for the in-step decode impls
    (:func:`instep_decodes`)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown pq_conv impl: {impl}")
    tail = dict(act=act, residual=residual)
    if impl in ("gdecode", "gdecode_iohw"):
        check_gdecode_codewords(params["codebooks"])
    if "perm" in params:
        # OPQ channel permutation (quantizer/opq.py): codebooks are shared
        # across groups, so the same within-group permutation applies to
        # each group's channel block
        perm = params["perm"].long()
        cg = x.shape[-1] // groups
        if groups > 1:
            perm = torch.cat([perm + g * cg for g in range(groups)])
        x = torch.index_select(x, -1, perm)
    if impl == "fusedconv":
        # the explicit choice keeps the kernel at any dtype
        if not pq_conv_fused.supports(params, stride=stride, groups=groups):
            raise ValueError(
                "pq_conv_fused: unsupported geometry (use 'memory_fused' "
                "for the auto-fallback mix)")
        out = pq_conv_fused.pq_conv_fused(x, params, stride=stride, pad=pad,
                                          groups=groups)
        return emit(out, out_dtype, act=act, residual=residual)
    if impl == "memory_fused":
        route = memory_fused_route(params, x.shape, x.dtype, stride=stride,
                                   pad=pad, groups=groups)
        if route in ("fusedconv", "fc1x1"):
            # x is permuted already: the recursion must not see 'perm'
            noperm = {k: v for k, v in params.items() if k != "perm"}
            return pq_conv(x, noperm, stride=stride, pad=pad, groups=groups,
                           impl=route, out_dtype=out_dtype, **tail)
        impl = route
    if impl == "fc1x1":
        return _pq_conv_fc1x1(x, params, stride=stride, pad=pad,
                              groups=groups, out_dtype=out_dtype, **tail)
    if impl == "lut":
        return pq_conv_lut(x, params, stride=stride, pad=pad, groups=groups,
                           out_dtype=out_dtype, **tail)
    if impl in ("gemm", "memory"):
        cout, kh, kw, _ = params["assignments"].shape
        if impl == "gemm" or _gemm_wins(x.shape, cout, kh, kw, groups,
                                        stride, pad):
            return pq_conv_gemm(x, params, stride=stride, pad=pad,
                                groups=groups, out_dtype=out_dtype, **tail)
        impl = "indecode_ohwi"
    return pq_conv_decode(
        x, params, stride=stride, pad=pad, groups=groups,
        layout=_INSTEP_LAYOUTS.get(impl), out_dtype=out_dtype,
        decoded=decoded, **tail,
    )


def conv_layer(x: torch.Tensor, p: dict, *, impl: str, stride: int,
               pad: int, groups: int = 1, out_dtype=None,
               decoded: torch.Tensor | None = None, act=None,
               residual=None) -> torch.Tensor:
    """One conv layer by the format of its param dict, emitted in
    ``out_dtype`` with ``residual`` (the output's shape) and ``act``
    ("relu", "gelu" or "gelu_tanh") after the bias, in the product's one epilogue
    (``ops.fc.emit``): a PQ dict (``codebooks``) through :func:`pq_conv`
    by ``impl`` (``decoded``: its weight from a grouped decode), an int8
    one (``kernel_q``) through :func:`conv_dense_int8` with its
    ``act_scale`` and ``out_scale``, any other through :func:`conv_dense`,
    whatever ``impl`` says. The forwards read a conv's format here only.

    pad: an int, or a (before, after) pair for both axes (:func:`same_pad`);
    an uneven pair pads x with zeros and runs the conv unpadded."""
    if isinstance(pad, tuple):
        lo, hi = pad
        if lo != hi:
            x = F.pad(x, (0, 0, lo, hi, lo, hi))
            lo = 0
        pad = lo
    conv = dict(stride=stride, pad=pad, groups=groups)
    if "codebooks" in p:
        return pq_conv(x, p, impl=impl, out_dtype=out_dtype, decoded=decoded,
                       act=act, residual=residual, **conv)
    if "kernel_q" in p:
        y = conv_dense_int8(x, p["kernel_q"], p["scale"], p["bias"],
                            act_scale=p.get("act_scale"),
                            out_scale=p.get("out_scale"), **conv)
        if act is not None and residual is None:
            # an int8 conv's float32 values take their activation before
            # the cast, as the family forwards have always run them
            with span("epilogue"):
                y, act = epilogue_fused.ACTIVATIONS[act](y), None
        return emit(y, out_dtype, act=act, residual=residual, int8=True)
    return conv_dense(x, p["kernel"], p["bias"], out_dtype=out_dtype,
                      act=act, residual=residual, **conv)


def instep_decodes(layers: dict) -> dict:
    """Decode, in one ``pq_decode`` launch, every conv and FC of a group
    that runs an in-step decode impl.

    layers: {key: (params, impl, row length)}, a conv's row its channels
    per group and an FC's its Cin; entries with another impl are skipped.
    Returns {key: weight} to hand to :func:`pq_conv` or ``ops.fc.pq_fc`` as
    ``decoded``: a conv's (Cout, kh, kw, Cg) buffer, an FC's (Cout, Cin)
    rows. The weights of the group live until the caller drops the dict."""
    group = [(key, p, n) for key, (p, impl, n) in layers.items()
             if impl in _INSTEP_LAYOUTS]
    with span("decode") if group else NO_SPAN:
        rows = pq_decode.decode_rows_many(
            [(p["codebooks"],
              p["assignments"].reshape(-1, p["assignments"].shape[-1]), n)
             for _, p, n in group])
        return {key: w.reshape(*p["assignments"].shape[:-1], n)
                for (key, p, n), w in zip(group, rows)}
