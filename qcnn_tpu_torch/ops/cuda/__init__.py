"""Hand-written CUDA kernels for Hopper (sources in ``qcnn_tpu_torch/csrc``),
each with its plain PyTorch version and a count of launches."""

from qcnn_tpu_torch.ops.cuda import (
    lrn_fused,
    pq_conv_fused,
    pq_decode,
    pq_fc,
    pq_fc_fused,
    pq_lut_gather,
)

KERNELS = {
    "pq_decode": pq_decode.KERNEL,
    "pq_lut_gather": pq_lut_gather.KERNEL,
    "pq_fc_fused": pq_fc_fused.KERNEL,
    "lrn_fused": lrn_fused.KERNEL,
    "pq_conv_fused": pq_conv_fused.KERNEL,
    "pq_fc": pq_fc.KERNEL,
    # the general paths of the two decode-GEMMs, for the shapes their wgmma
    # kernels do not take
    "pq_fc_fused_general": pq_fc_fused.GENERAL,
    "pq_conv_fused_general": pq_conv_fused.GENERAL,
}


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def launches() -> dict[str, int]:
    return {name: kernel.launches for name, kernel in KERNELS.items()}
