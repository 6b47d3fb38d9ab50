"""The paper's own networks (§4): configs + ladders.

Counterpart of ``repro.configs.paper_nets``; each ``module`` is the
port's model module.

  * ResNet-20 / CIFAR-10   (Table 1, 2)   — ladder "cifar10"
  * DarkNet-19 / ImageNet  (Table 3)      — ladder "imagenet"
  * KWS net / speech cmds  (Table 4, 5)   — ladder "kws"
  * ResNet-32 / CIFAR-100  (Table 6)      — ladder "cifar100"
"""
from __future__ import annotations

import dataclasses

from ..core.quant import LADDERS
from ..models import darknet, kws, resnet


@dataclasses.dataclass(frozen=True)
class PaperNet:
    name: str
    ladder: str                      # key into core.quant.LADDERS
    module: object                   # models.{resnet,kws,darknet}
    config: object                   # full-paper config
    reduced: object                  # CPU-trainable reduced config
    input_shape: tuple               # per-example input (full config)
    reduced_input_shape: tuple
    num_classes: int
    reduced_classes: int


PAPER_NETS = {
    "resnet20-cifar10": PaperNet(
        "resnet20-cifar10", "cifar10", resnet,
        resnet.ResNetConfig.resnet20(), resnet.ResNetConfig.reduced(),
        (32, 32, 3), (16, 16, 3), 10, 10),
    "resnet32-cifar100": PaperNet(
        "resnet32-cifar100", "cifar100", resnet,
        resnet.ResNetConfig.resnet32(),
        dataclasses.replace(resnet.ResNetConfig.reduced(), num_classes=20),
        (32, 32, 3), (16, 16, 3), 100, 20),
    "kws": PaperNet(
        "kws", "kws", kws,
        kws.KWSConfig(), kws.KWSConfig.reduced(),
        (140, 39), (24, 8), 12, 4),
    "darknet19-imagenet": PaperNet(
        "darknet19-imagenet", "imagenet", darknet,
        darknet.DarkNetConfig(), darknet.DarkNetConfig.reduced(),
        (224, 224, 3), (32, 32, 3), 1000, 16),
}


def ladder_for(net: PaperNet):
    return LADDERS[net.ladder]
