"""ConvNeXt backbone family (port of
salience_detr_tpu/models/backbones/convnext.py).

``forward(images (B, 3, H, W))`` returns {stage_idx: (B, C_i, H/s, W/s)}, the
post-stage maps (stage i has stride 4 * 2**i).  Module names are
torchvision's ``ConvNeXt.features``, so ``state_dict()`` keys are the
converter's ``backbone.features.*``:

* ``features.0``: the stem, a 4x4 stride-4 conv and a channels LayerNorm
  (eps 1e-6);
* ``features.{2s+1}``: stage s, a sequence of :class:`CNBlock`;
* ``features.{2s}`` (s >= 1): a channels LayerNorm and a 2x2 stride-2 conv.

The stem and downsampling convs pad as flax's "SAME" does.  Block k of the
whole backbone drops its branch with ``sd * k / (total - 1)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from salience_detr_torch.models.layers import (
    DropPath,
    LayerNorm2d,
    Permute,
    SamePadConv2d,
    flax_default_init_,
    linear_drop_rates,
)

# depths, dims and the reference registry's stochastic depth per arch
ARCH_SETTINGS: Dict[str, Dict] = {
    "conv_t": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), sd=0.1),
    "conv_s": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), sd=0.4),
    "conv_b": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024), sd=0.5),
    "conv_l": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536), sd=0.5),
}


class CNBlock(nn.Module):
    """7x7 depthwise conv (bias) -> LayerNorm -> Linear to 4C -> exact GELU
    -> Linear to C -> times ``layer_scale`` (C, 1, 1) -> drop path, plus the
    input."""

    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale: float = 1e-6):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute(0, 2, 3, 1),
            nn.LayerNorm(dim, eps=1e-6),
            nn.Linear(dim, 4 * dim),
            nn.GELU(),
            nn.Linear(4 * dim, dim),
            Permute(0, 3, 1, 2),
        )
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), layer_scale))
        self.stochastic_depth = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x) * self.layer_scale.to(x.dtype)
        return x + self.stochastic_depth(y)


class ConvNeXtBackbone(nn.Module):
    weights_prefix = ""

    def __init__(self, arch: str = "conv_l", return_indices: Tuple[int, ...] = (1, 2, 3),
                 stochastic_depth_prob: Optional[float] = None):
        super().__init__()
        cfg = ARCH_SETTINGS[arch]
        depths, dims = cfg["depths"], cfg["dims"]
        sd = cfg["sd"] if stochastic_depth_prob is None else stochastic_depth_prob
        rates = iter(linear_drop_rates(sd, depths))
        self.return_indices = tuple(return_indices)
        self.num_channels = [dims[i] for i in self.return_indices]
        layers = [nn.Sequential(SamePadConv2d(3, dims[0], 4, 4), LayerNorm2d(dims[0], eps=1e-6))]
        for s in range(4):
            if s > 0:
                layers.append(nn.Sequential(LayerNorm2d(dims[s - 1], eps=1e-6),
                                            SamePadConv2d(dims[s - 1], dims[s], 2, 2)))
            layers.append(nn.Sequential(*(CNBlock(dims[s], next(rates)) for _ in range(depths[s]))))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        outputs = {}
        x = self.features[0](x)
        for s in range(4):
            if s > 0:
                x = self.features[2 * s](x)
            x = self.features[2 * s + 1](x)
            if s in self.return_indices:
                outputs[s] = x
        return outputs

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initializers: flax's defaults, layer scale 1e-6."""
        flax_default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, CNBlock):
                m.layer_scale.fill_(1e-6)
