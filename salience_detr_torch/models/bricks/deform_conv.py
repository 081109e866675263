"""Modulated deformable convolution, DCNv2 (port of
salience_detr_tpu/models/bricks/deform_conv.py ``DeformConv2dPack``).

A 3x3 convolution whose 9 taps move by offsets and are scaled by masks that
the layer predicts from its own input: ``conv_offset`` (Cin -> 18, (dy, dx)
interleaved per tap) and ``conv_mask`` (Cin -> 9, through a sigmoid), both
3x3 at the layer's stride with bias.  The sampling and its product with the
weight run in ``ops/deform_conv.deform_conv2d``: on CUDA one fused kernel
for bf16 and f16 (autocast) layers of up to 128 output channels, else the
columns kernel and one ``torch.matmul``; on the CPU the plain version.  Submodule
names are upstream's, so the state-dict keys are ``conv_offset.*``,
``conv_mask.*`` and ``deform_conv2d.weight`` (F, Cin, 3, 3), without a bias
(the ResNet's ``conv3x3_dcn``).  Input and output are NCHW; the sampling
takes the input channels-last.
"""

from __future__ import annotations

import torch
from torch import nn

from salience_detr_torch.ops.deform_conv import TAPS, deform_conv2d


class _Weight(nn.Module):
    """Holds the (F, Cin, 3, 3) kernel under upstream's name ``deform_conv2d``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))


class DeformConv2dPack(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv_offset = nn.Conv2d(in_channels, 2 * TAPS, 3, stride, 1)
        self.conv_mask = nn.Conv2d(in_channels, TAPS, 3, stride, 1)
        self.deform_conv2d = _Weight(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_autocast_enabled(x.device.type):
            x = x.to(torch.get_autocast_dtype(x.device.type))
        offsets = self.conv_offset(x).permute(0, 2, 3, 1)  # (B, Ho, Wo, 18)
        mask = torch.sigmoid(self.conv_mask(x)).permute(0, 2, 3, 1)  # (B, Ho, Wo, 9)
        w = self.deform_conv2d.weight  # (F, Cin, ky, kx) -> (ky, kx, Cin, F), the JAX (9, Cin, F)
        w = w.permute(2, 3, 1, 0).reshape(TAPS, w.shape[1], w.shape[0])
        out = deform_conv2d(x.permute(0, 2, 3, 1).contiguous(), offsets, mask, w, self.stride)
        return out.permute(0, 3, 1, 2)
