"""Shared building blocks (port of salience_detr_tpu/models/layers.py).

Convolutions are NCHW on cuDNN.  Submodule names follow the upstream
PyTorch layout, so ``state_dict()`` keys are the weight converter's source
names.  The JAX package's ``Linear`` (a Dense with torch's default init) is
``torch.nn.Linear`` here, and its ``BatchNorm`` is :class:`BatchNorm2d`, which
uses its running statistics in eval mode and trains as flax does.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from salience_detr_torch.parallel.mesh import all_reduce_sum


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
    (see ``_ContiguousGrad``).  Eval mode is ``nn.BatchNorm2d``'s.

    Synced over the ranks of a data-parallel step when ``process_group`` is
    set (:func:`sync_batch_norm`) and holds more than one rank: the per-channel
    (count, sum x, sum x^2) are all-reduced in float32 (the only collective,
    an ``all_reduce``, differentiable: its backward all-reduces the
    statistics' gradients), and the layer normalises with flax's
    ``var = max(E[x^2] - E[x]^2, 0)`` over the global batch, which is what the
    JAX step computes on the sharded batch.  A world of one takes the local
    path above.  ``nn.SyncBatchNorm`` is not used: it refuses CPU tensors, its
    gloo path all-gathers, and its running variance is the unbiased one."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = self.process_group
        if group is not None and dist.get_world_size(group) > 1:
            return _ContiguousGrad.apply(self._synced(x, group))
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return _ContiguousGrad.apply(y)

    def _synced(self, x: torch.Tensor, group) -> torch.Tensor:
        xf = x.float()
        C = xf.shape[1]
        count = torch.full((1,), xf.numel() // C, dtype=torch.float32, device=xf.device)
        stats = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count])
        stats = all_reduce_sum(stats, differentiable=True, group=group)
        n = stats[2 * C]
        mean = stats[:C] / n
        var = (stats[C:2 * C] / n - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def sync_batch_norm(model: nn.Module, group) -> int:
    """Sync every :class:`BatchNorm2d` of ``model`` over ``group`` (None
    unsyncs); returns how many there are."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.process_group = group
    return len(layers)


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


class DropPath(nn.Module):
    """Per-sample stochastic depth ("row" mode, torchvision's
    ``StochasticDepth(p, "row")``): in train mode with ``p > 0`` each sample
    of the batch keeps its branch with probability 1 - p, drawn as a
    (B, 1, ..., 1) Bernoulli mask from ``self.generator`` (set for a step by
    :func:`set_drop_path_generator`; nothing else is drawn from), and the
    kept rows are scaled by 1 / (1 - p).  The identity in eval mode or at
    p = 0.  In a data-parallel step (``rows`` = (offset, global batch)) the
    mask is drawn at the global batch's size and the rank keeps its rows."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator = None
        self.rows = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in train mode needs a generator (set_drop_path_generator)")
        keep = 1.0 - self.p
        offset, total = self.rows if self.rows is not None else (0, x.shape[0])
        mask = torch.empty((total,) + (1,) * (x.dim() - 1), device=x.device, dtype=torch.float32)
        mask.bernoulli_(keep, generator=self.generator)
        return x * mask[offset:offset + x.shape[0]].to(x.dtype) / keep

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_drop_path_generator(model: nn.Module, generator, rows=None) -> None:
    """Give every ``DropPath`` of ``model`` the generator of the next step,
    and in a data-parallel step the rank's ``rows`` = (offset, global batch
    size) of each micro-batch."""
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = generator
            m.rows = rows


def linear_drop_rates(sd: float, depths) -> list:
    """ConvNeXt, Swin and FocalNet: block k of the whole backbone (counted
    over all stages) drops with sd * k / (total - 1)."""
    total = sum(depths)
    return [sd * k / max(total - 1, 1) for k in range(total)]


class Permute(nn.Module):
    """``x.permute(*dims)`` as a module: it keeps torchvision's sequential
    indices (and so the state-dict keys) of the blocks that permute."""

    def __init__(self, *dims: int):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (torchvision's
    ``LayerNorm2d``): normalise each pixel's C values."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class SamePadConv2d(nn.Conv2d):
    """A conv with TensorFlow's "SAME" padding, computed from the input size:
    flax's default for ``nn.Conv``, which the JAX backbones' patch and
    downsampling convs use (a kernel-k stride-k conv gives ceil(H / k) rows,
    the padding split low = total // 2, high = the rest)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(x.shape[-2:], self.kernel_size, self.stride):
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        (top, bottom), (left, right) = pads
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator, fan_in: int = None) -> torch.Tensor:
    """flax's default kernel init (``lecun_normal``): a normal truncated at
    two standard deviations with variance 1 / fan_in (fan_in of a torch
    Linear or Conv2d weight: its row size)."""
    fan_in = fan_in or weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def flax_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults on every conv, transposed conv and Linear under
    ``module`` (lecun-normal kernels, zero biases) and unit LayerNorms."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            # flax's fan in: the kernel's input rows (a transposed conv's
            # weight is (in, out, kh, kw) here, (kh, kw, in, out) in flax)
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) else None
            lecun_normal_(m.weight, generator, fan_in)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


def trunc_normal_002_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``truncated_normal(0.02)``: std 0.02, cut at two of them."""
    return nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04, generator=generator)


def attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor = None,
                  scale: float = None) -> torch.Tensor:
    """Softmax attention as the JAX backbones compute it: q, k, v (N, H, L,
    d); logits q k^T (times ``scale``) plus ``bias`` in float32, whatever the
    compute dtype (flax ``preferred_element_type=float32``), the softmax in
    float32, the probabilities in v's dtype times v.  Returns (N, H, L, d)."""
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-2, -1))
        if scale is not None:
            logits = logits * scale
        if bias is not None:
            logits = logits + bias.float()
        probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)
