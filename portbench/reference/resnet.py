"""ResNet backbone family with FrozenBatchNorm (port of
salience_detr_tpu/models/backbones/resnet.py).

``forward(images (B, 3, H, W))`` returns {stage_idx: (B, C_i, H/s, W/s)} for
stage_idx in ``return_indices`` (stage i has stride 4 * 2**i).  Module names
are torchvision's, so ``state_dict()`` keys are upstream's ``backbone.*``.
``stage_with_dcn`` swaps conv2 of every block of the marked stages for a
modulated deformable conv (``DeformConv2dPack``, no bias): at the stride of
the 3x3 conv in a Bottleneck, always stride 1 in a BasicBlock (whose stride
is on conv1), as in the JAX package.  The wide ResNets widen the
Bottleneck's inner convs (``width`` per group 128); the ResNeXts make its 3x3
conv a grouped conv (``groups``), which DCN does not take.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import FrozenBatchNorm2d

# name: block type, blocks per stage, width per group and groups of the
# Bottleneck's 3x3 conv (the JAX package's table)
ARCH_SETTINGS: Dict[str, Dict] = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2), width=64),
    "resnet34": dict(block="basic", layers=(3, 4, 6, 3), width=64),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3), width=64),
    "resnet101": dict(block="bottleneck", layers=(3, 4, 23, 3), width=64),
    "resnet152": dict(block="bottleneck", layers=(3, 8, 36, 3), width=64),
    "wide_resnet50_2": dict(block="bottleneck", layers=(3, 4, 6, 3), width=128),
    "wide_resnet101_2": dict(block="bottleneck", layers=(3, 4, 23, 3), width=128),
    "resnext50_32x4d": dict(block="bottleneck", layers=(3, 4, 6, 3), width=4, groups=32),
    "resnext101_32x4d": dict(block="bottleneck", layers=(3, 4, 23, 3), width=4, groups=32),
    "resnext101_32x8d": dict(block="bottleneck", layers=(3, 4, 23, 3), width=8, groups=32),
    "resnext101_64x4d": dict(block="bottleneck", layers=(3, 4, 23, 3), width=4, groups=64),
}


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False)


def _conv3x3(cin: int, cout: int, stride: int, with_dcn: bool, groups: int = 1) -> nn.Module:
    if with_dcn:
        if groups != 1:
            raise NotImplementedError("DCN + grouped conv is not supported")
        raise NotImplementedError("the reference has no deformable convolution")
    return _conv(cin, cout, 3, stride, groups)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 with_dcn: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv3x3(planes, planes, 1, with_dcn)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 with_dcn: bool = False, base_width: int = 64, groups: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        # torchvision puts the stride (and the ResNeXt groups) on the 3x3 conv
        self.conv2 = _conv3x3(width, width, stride, with_dcn, groups)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = FrozenBatchNorm2d(out_ch)
        self.downsample = _downsample(inplanes, out_ch, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNetBackbone(nn.Module):
    # where a bare ImageNet file's names go under ``backbone.``
    weights_prefix = ""

    def __init__(self, arch: str = "resnet50", return_indices: Tuple[int, ...] = (1, 2, 3),
                 stage_with_dcn: Tuple[bool, ...] = (False, False, False, False)):
        super().__init__()
        cfg = ARCH_SETTINGS[arch]
        block = Bottleneck if cfg["block"] == "bottleneck" else BasicBlock
        self.return_indices = tuple(return_indices)
        self.num_channels = [64 * block.expansion * 2**i for i in self.return_indices]
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes = 64
        for stage in range(4):
            planes = 64 * 2**stage
            blocks = []
            for blk in range(cfg["layers"][stage]):
                stride = 2 if (stage > 0 and blk == 0) else 1
                downsample = blk == 0 and (stage > 0 or block is Bottleneck)
                extra = dict(base_width=cfg["width"], groups=cfg.get("groups", 1)) if block is Bottleneck else {}
                blocks.append(block(inplanes, planes, stride, downsample, stage_with_dcn[stage], **extra))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outputs = {}
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.return_indices:
                outputs[stage] = x
        return outputs


def freeze_stages(backbone: ResNetBackbone, freeze_indices: Sequence[int]) -> None:
    """Stop training the stem and the given stages (the JAX package's
    ``frozen_param_predicate``, the reference's ``_freeze_stages``): any
    frozen stage also freezes the stem.  The BatchNorms are frozen anyway."""
    if len(freeze_indices) == 0:
        return
    backbone.conv1.requires_grad_(False)
    for idx in freeze_indices:
        getattr(backbone, f"layer{idx + 1}").requires_grad_(False)
