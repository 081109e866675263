"""ChannelMapper neck (port of salience_detr_tpu/models/necks/channel_mapper.py):
1x1 conv + GroupNorm(32) per input level, extra levels by stride-2 3x3 convs
chained from the last input feature."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from portbench.reference.layers import ConvNormAct


class ChannelMapper(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 4):
        super().__init__()
        self.num_inputs = len(in_channels)
        convs = [ConvNormAct(c, out_channels, 1) for c in in_channels]
        cin = in_channels[-1]
        for _ in range(self.num_inputs, num_outs):
            convs.append(ConvNormAct(cin, out_channels, 3, stride=2))
            cin = out_channels
        self.convs = nn.ModuleList(convs)

    def forward(self, inputs: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        feats = list(inputs.values())
        assert len(feats) == self.num_inputs
        outs = [conv(f) for conv, f in zip(self.convs, feats)]
        x = feats[-1]
        for conv in self.convs[self.num_inputs:]:
            x = conv(x)
            outs.append(x)
        return outs
