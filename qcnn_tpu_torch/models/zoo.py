"""Model zoo: the six reference architectures as declarative specs.

A copy of ``qcnn_tpu/models/zoo.py``; the port imports nothing of the JAX
package.

Layer graphs transcribed from the reference's config-as-code
(src/CaffePara.cc: AlexNet :20-52, CaffeNet :54-86, VggCnnS :88-119,
VGG16 :121-169, CaffeNetFGB :171-203, CaffeNetFGD :205-237).
"""

from __future__ import annotations

from qcnn_tpu_torch.core import (
    ConvSpec,
    DropoutSpec,
    FCSpec,
    LRNSpec,
    ModelSpec,
    PoolSpec,
    ReLUSpec,
    SoftmaxSpec,
)


def _alexnet_like(
    name: str,
    *,
    lrn_after_pool: bool,
    dropout: float,
    num_classes: int,
) -> ModelSpec:
    """AlexNet and CaffeNet differ only in LRN/Pool ordering after conv1/conv2
    (CaffePara.cc:29-36 vs :63-70); the FGB/FGD variants change dropout rate
    and class count (:197-201, :231-235)."""
    relu_lrn_pool: tuple
    if lrn_after_pool:  # CaffeNet order: ReLU, Pool, LRN
        block1 = (ReLUSpec(), PoolSpec(kernel=3, stride=2), LRNSpec(5, 1e-4, 0.75, 1.0))
        block2 = (ReLUSpec(), PoolSpec(kernel=3, stride=2), LRNSpec(5, 1e-4, 0.75, 1.0))
    else:  # AlexNet order: ReLU, LRN, Pool
        block1 = (ReLUSpec(), LRNSpec(5, 1e-4, 0.75, 1.0), PoolSpec(kernel=3, stride=2))
        block2 = (ReLUSpec(), LRNSpec(5, 1e-4, 0.75, 1.0), PoolSpec(kernel=3, stride=2))
    return ModelSpec(
        name=name,
        in_height=227,
        in_width=227,
        in_channels=3,
        layers=(
            ConvSpec(kernel=11, out_channels=96, pad=0, groups=1, stride=4),
            *block1,
            ConvSpec(kernel=5, out_channels=256, pad=2, groups=2, stride=1),
            *block2,
            ConvSpec(kernel=3, out_channels=384, pad=1, groups=1, stride=1),
            ReLUSpec(),
            ConvSpec(kernel=3, out_channels=384, pad=1, groups=2, stride=1),
            ReLUSpec(),
            ConvSpec(kernel=3, out_channels=256, pad=1, groups=2, stride=1),
            ReLUSpec(),
            PoolSpec(kernel=3, stride=2),
            FCSpec(4096),
            ReLUSpec(),
            DropoutSpec(dropout),
            FCSpec(4096),
            ReLUSpec(),
            DropoutSpec(dropout),
            FCSpec(num_classes),
            SoftmaxSpec(),
        ),
    )


def alexnet() -> ModelSpec:
    return _alexnet_like(
        "AlexNet", lrn_after_pool=False, dropout=0.5, num_classes=1000
    )


def caffenet() -> ModelSpec:
    return _alexnet_like(
        "CaffeNet", lrn_after_pool=True, dropout=0.5, num_classes=1000
    )


def caffenet_fgb() -> ModelSpec:
    return _alexnet_like(
        "CaffeNetFGB", lrn_after_pool=True, dropout=0.7, num_classes=518
    )


def caffenet_fgd() -> ModelSpec:
    return _alexnet_like(
        "CaffeNetFGD", lrn_after_pool=True, dropout=0.5, num_classes=200
    )


def vgg_cnn_s() -> ModelSpec:
    return ModelSpec(
        name="VggCnnS",
        in_height=224,
        in_width=224,
        in_channels=3,
        layers=(
            ConvSpec(kernel=7, out_channels=96, pad=0, groups=1, stride=2),
            ReLUSpec(),
            LRNSpec(5, 5e-4, 0.75, 2.0),
            PoolSpec(kernel=3, stride=3),
            ConvSpec(kernel=5, out_channels=256, pad=1, groups=1, stride=1),
            ReLUSpec(),
            PoolSpec(kernel=2, stride=2),
            ConvSpec(kernel=3, out_channels=512, pad=1, groups=1, stride=1),
            ReLUSpec(),
            ConvSpec(kernel=3, out_channels=512, pad=1, groups=1, stride=1),
            ReLUSpec(),
            ConvSpec(kernel=3, out_channels=512, pad=1, groups=1, stride=1),
            ReLUSpec(),
            PoolSpec(kernel=3, stride=3),
            FCSpec(4096),
            ReLUSpec(),
            DropoutSpec(0.5),
            FCSpec(4096),
            ReLUSpec(),
            DropoutSpec(0.5),
            FCSpec(1000),
            SoftmaxSpec(),
        ),
    )


def vgg16() -> ModelSpec:
    def conv_block(channels: int, count: int):
        layers = []
        for _ in range(count):
            layers.append(ConvSpec(kernel=3, out_channels=channels, pad=1, stride=1))
            layers.append(ReLUSpec())
        layers.append(PoolSpec(kernel=2, stride=2))
        return layers

    return ModelSpec(
        name="VGG16",
        in_height=224,
        in_width=224,
        in_channels=3,
        layers=(
            *conv_block(64, 2),
            *conv_block(128, 2),
            *conv_block(256, 3),
            *conv_block(512, 3),
            *conv_block(512, 3),
            FCSpec(4096),
            ReLUSpec(),
            DropoutSpec(0.5),
            FCSpec(4096),
            ReLUSpec(),
            DropoutSpec(0.5),
            FCSpec(1000),
            SoftmaxSpec(),
        ),
    )


MODELS = {
    "alexnet": alexnet,
    "caffenet": caffenet,
    "vgg_cnn_s": vgg_cnn_s,
    "vgg16": vgg16,
    "caffenet_fgb": caffenet_fgb,
    "caffenet_fgd": caffenet_fgd,
}


def get_model(name: str) -> ModelSpec:
    key = name.lower().replace("-", "_")
    if key not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[key]()
