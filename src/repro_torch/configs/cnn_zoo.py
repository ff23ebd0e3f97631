"""CNN configs for the paper's own study (CIFAR-10-scale image models).

The paper evaluates AlexNet, GoogLeNet, LeNet, BN-LeNet, GN-LeNet, ResNet20.
We implement the LeNet family exactly as described (BN-LeNet = LeNet with
BatchNorm after each conv; GN-LeNet swaps GroupNorm in) plus a compact
AlexNet-style net and a ResNet-20-style net with BatchNorm — enough to
reproduce every paper phenomenon (BN divergence, GN rescue, algorithm loss)
on CPU with synthetic data.
"""
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class CNNConfig:
    name: str
    conv_channels: Tuple[int, ...]            # channels per conv block
    kernel_sizes: Tuple[int, ...]
    pool_after: Tuple[bool, ...]              # 2x2 maxpool after block?
    norm: Optional[str]                       # None | "batch" | "group" | "batchrenorm"
    group_size: int = 2                       # paper: G_size=2 works best
    fc_dims: Tuple[int, ...] = (256,)
    n_classes: int = 10
    image_size: int = 16                      # synthetic-CIFAR side
    in_channels: int = 3
    residual: bool = False                    # ResNet-style skip connections


def lenet(norm=None, name=None) -> CNNConfig:
    return CNNConfig(
        name=name or {"batch": "bn-lenet", "group": "gn-lenet",
                      "batchrenorm": "brn-lenet", None: "lenet"}[norm],
        conv_channels=(32, 32, 64),
        kernel_sizes=(5, 5, 5),
        pool_after=(True, True, True),
        norm=norm,
        fc_dims=(64,),
    )


def alexnet_s() -> CNNConfig:
    return CNNConfig(
        name="alexnet-s",
        conv_channels=(64, 128, 128),
        kernel_sizes=(3, 3, 3),
        pool_after=(True, True, True),
        norm=None,
        fc_dims=(256, 128),
    )


def resnet20_s(norm="batch") -> CNNConfig:
    return CNNConfig(
        name=f"resnet-s-{norm or 'nonorm'}",
        conv_channels=(16, 16, 32, 32, 64, 64),
        kernel_sizes=(3, 3, 3, 3, 3, 3),
        pool_after=(False, False, True, False, True, False),
        norm=norm,
        fc_dims=(),
        residual=True,
    )


CNN_ZOO = {
    "lenet": lenet(None),
    "bn-lenet": lenet("batch"),
    "gn-lenet": lenet("group"),
    "brn-lenet": lenet("batchrenorm"),
    "alexnet-s": alexnet_s(),
    "resnet-s": resnet20_s("batch"),
    "resnet-s-gn": resnet20_s("group"),
}
