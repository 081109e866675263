"""RepVGG-PluX PAN network re-fusing the encoder memory as 2D maps (port of
salience_detr_tpu/models/necks/repnet.py).

The JAX package runs its grouped convs as dense convs with a block-diagonal
kernel, a TPU lane workaround; here they are plain ``nn.Conv2d(groups=4)``
holding the grouped weight.  BatchNorm (``models.layers.BatchNorm2d``) uses
its running statistics in eval mode and, in train mode, batch statistics with
flax's running update.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from portbench.reference.layers import BatchNorm2d, GlobalContextSE


def nearest_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour NCHW resize, source index floor(i * in / out)."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    return x.index_select(2, rows).index_select(3, cols)


class ConvBNAct(nn.Sequential):
    """Conv (index 0, no bias) + BatchNorm (index 1) + SiLU when ``act``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
                 groups: int = 1, act: bool = True):
        layers = [
            nn.Conv2d(cin, cout, kernel_size, stride, (kernel_size - 1) // 2,
                      groups=groups, bias=False),
            BatchNorm2d(cout, eps=1e-5),
        ]
        if act:
            layers.append(nn.SiLU())
        super().__init__(*layers)


class RepVggPluXBlock(nn.Module):
    """Grouped 3x3 + 1x1 conv branches, SiLU, global-context SE, identity
    shortcut (the network only builds blocks with equal in/out channels)."""

    def __init__(self, channels: int, groups: int = 4):
        super().__init__()
        self.conv1 = ConvBNAct(channels, channels, 3, groups=groups, act=False)
        self.conv2 = ConvBNAct(channels, channels, 1, groups=groups, act=False)
        self.se_module = GlobalContextSE(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.se_module(nn.functional.silu(self.conv1(x) + self.conv2(x))) + x


class CSPRepPluXLayer(nn.Module):
    """Two 1x1 branches, one through 3 RepVGG blocks (expansion 1)."""

    def __init__(self, cin: int, cout: int, groups: int = 4):
        super().__init__()
        self.conv1 = ConvBNAct(cin, cout, 1)
        self.conv2 = ConvBNAct(cin, cout, 1)
        self.bottlenecks = nn.Sequential(*[RepVggPluXBlock(cout, groups) for _ in range(3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bottlenecks(self.conv1(x)) + self.conv2(x)


class RepVGGPluXNetwork(nn.Module):
    """PAN: top-down lateral fusion, then bottom-up path aggregation."""

    def __init__(self, in_channels_list: Sequence[int], out_channels_list: Sequence[int],
                 groups: int = 4):
        super().__init__()
        n = len(in_channels_list)
        ins, outs = list(in_channels_list), list(out_channels_list)
        # lateral_convs[i] reduces the top-down feature arriving at level i + 1
        self.lateral_convs = nn.ModuleList(
            ConvBNAct(ins[-1] if i == n - 2 else outs[i + 1], outs[i], 1) for i in range(n - 1)
        )
        self.layer_blocks = nn.ModuleList(
            CSPRepPluXLayer(outs[i] + ins[i], outs[i], groups=groups) for i in range(n - 1)
        )
        self.downsample_blocks = nn.ModuleList(
            ConvBNAct(outs[i], outs[i + 1], 3, stride=2) for i in range(n - 1)
        )
        self.pan_blocks = nn.ModuleList(
            CSPRepPluXLayer(outs[i + 1] + outs[i], outs[i + 1], groups=groups)
            for i in range(n - 1)
        )

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        n = len(feats)
        inner_outs = [feats[-1]]
        for idx in range(n - 1, 0, -1):
            feat_high = self.lateral_convs[idx - 1](inner_outs[0])
            inner_outs[0] = feat_high
            upsample = nearest_resize(feat_high, feats[idx - 1].shape[-2:])
            inner_outs.insert(
                0, self.layer_blocks[idx - 1](torch.cat([upsample, feats[idx - 1]], dim=1))
            )
        results = [inner_outs[0]]
        for idx in range(n - 1):
            down = self.downsample_blocks[idx](results[-1])
            results.append(
                self.pan_blocks[idx](torch.cat([down, inner_outs[idx + 1]], dim=1))
            )
        return results
