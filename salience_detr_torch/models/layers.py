"""Shared building blocks (port of salience_detr_tpu/models/layers.py).

Convolutions are NCHW on cuDNN.  Submodule names follow the upstream
PyTorch layout, so ``state_dict()`` keys are the weight converter's source
names.  The JAX package's ``Linear`` (a Dense with torch's default init) is
``torch.nn.Linear`` here, and its ``BatchNorm`` is :class:`BatchNorm2d`, which
uses its running statistics in eval mode and trains as flax does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, all buffers."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * w
        return x * w[:, None, None].to(x.dtype) + b[:, None, None].to(x.dtype)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on its gradient in the standard
    (contiguous NCHW) layout.

    At one image the gradient that reaches the neck's maps is a slice of a
    (1, S, C) token gradient: channels-last strides with a batch stride of C
    where the standard one is H*W*C.  PyTorch's CPU ``batch_norm`` backward
    reads such a gradient wrongly (torch 2.13; ``tools/bn_grad_layout_probe.py``
    shows it), so the neck's BatchNorm hands it a contiguous copy.  A
    gradient that is contiguous already passes through as it is."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode follows flax's ``nn.BatchNorm``:
    normalise with the batch mean and biased variance (f32 statistics), and
    update the running statistics as ``r = 0.9 r + 0.1 batch`` (flax momentum
    0.9, torch momentum 0.1) with the BIASED batch variance, where
    ``nn.BatchNorm2d`` would use the unbiased one (n / (n - 1) larger).
    In train mode the gradient reaches ``batch_norm``'s backward contiguous
    (see ``_ContiguousGrad``).  Eval mode is ``nn.BatchNorm2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return _ContiguousGrad.apply(y)


class ConvNormAct(nn.Sequential):
    """Conv2d without bias (index 0) + GroupNorm(32) (index 1): the form the
    ChannelMapper uses (no activation)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride, (kernel_size - 1) // 2,
                      bias=False),
            nn.GroupNorm(32, out_channels, eps=1e-5),
        )


class MLP(nn.Module):
    """Stacked Linear + ReLU head."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class GlobalContextSE(nn.Module):
    """GCNet-style squeeze-excitation used inside the RepVGG blocks."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.conv_mask = nn.Conv2d(channels, 1, 1)
        self.se_module = nn.Sequential(
            nn.Conv2d(channels, channels // reduction, 1, bias=False),
            nn.ReLU(),
            nn.Conv2d(channels // reduction, channels, 1, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        ctx = self.conv_mask(x).reshape(b, 1, h * w).softmax(dim=2)  # (B, 1, HW)
        context = torch.einsum("bcs,bos->bc", x.reshape(b, c, h * w), ctx)
        return self.se_module(context.reshape(b, c, 1, 1)) * x
