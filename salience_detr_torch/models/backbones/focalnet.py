"""FocalNet backbone family (port of
salience_detr_tpu/models/backbones/focalnet.py).

``forward(images (B, 3, H, W))`` returns {stage_idx: (B, C_i, H/s, W/s)}, each
returned level through its own LayerNorm; inside, the tokens are NHWC.
Upstream wraps the network as ``nn.Sequential(fx, PostProcess)`` with the
per-level norms in the second part, so ``state_dict()`` keys are the
converter's ``backbone.0.patch_embed.*``, ``backbone.0.layers.{s}.blocks.{b}.*``,
``backbone.0.layers.{s}.downsample.*`` and ``backbone.1.norm{idx}.*``.

Focal modulation (the JAX module's order): ``f`` splits into q, the context
and L + 1 gates; focal level l is a depthwise conv of kernel 2l + window (no
bias) and an exact GELU, gated into the sum; the global context is the GELU
of the spatial mean of the last level's context; ``normalize_modulator``
divides the sum by L + 1; ``h`` (1x1 conv, bias) makes the modulator; the
optional ``ln`` comes before ``proj``.  Blocks are pre-norm, or post-norm
with ``use_postln``, with layer scales ``gamma_1/2`` (init 1e-4).  With
``conv_embed`` the stem is a 7x7 stride-4 conv (pad 2) and the downsamples
3x3 stride-2 convs (pad 1); else kernel = stride convs ("SAME" padding).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from salience_detr_torch.models.layers import DropPath, SamePadConv2d, flax_default_init_, linear_drop_rates

ARCH_SETTINGS: Dict[str, Dict] = {
    "focalnet_tiny_srf": dict(embed_dim=96, depths=(2, 2, 6, 2), focal_levels=(2,) * 4,
                              focal_windows=(3,) * 4, conv_embed=False, postln=False,
                              layerscale=False, norm_mod=False, sd=0.2),
    "focalnet_tiny_lrf": dict(embed_dim=96, depths=(2, 2, 18, 2), focal_levels=(3,) * 4,
                              focal_windows=(3,) * 4, conv_embed=False, postln=False,
                              layerscale=False, norm_mod=False, sd=0.2),
    "focalnet_base_lrf": dict(embed_dim=128, depths=(2, 2, 18, 2), focal_levels=(3,) * 4,
                              focal_windows=(3,) * 4, conv_embed=False, postln=False,
                              layerscale=False, norm_mod=False, sd=0.5),
    "focalnet_large_lrf": dict(embed_dim=192, depths=(2, 2, 18, 2), focal_levels=(3,) * 4,
                               focal_windows=(5,) * 4, conv_embed=True, postln=True,
                               layerscale=True, norm_mod=False, sd=0.5),
    "focalnet_large_lrf_fl4": dict(embed_dim=192, depths=(2, 2, 18, 2), focal_levels=(4,) * 4,
                                   focal_windows=(3,) * 4, conv_embed=True, postln=True,
                                   layerscale=True, norm_mod=True, sd=0.5),
    "focalnet_xlarge_lrf_fl4": dict(embed_dim=256, depths=(2, 2, 18, 2), focal_levels=(4,) * 4,
                                    focal_windows=(3,) * 4, conv_embed=True, postln=True,
                                    layerscale=True, norm_mod=True, sd=0.5),
    "focalnet_huge_fl4": dict(embed_dim=352, depths=(2, 2, 18, 2), focal_levels=(4,) * 4,
                              focal_windows=(3,) * 4, conv_embed=True, postln=True,
                              layerscale=True, norm_mod=False, postln_in_mod=True, sd=0.5),
}


class FocalModulation(nn.Module):
    def __init__(self, dim: int, focal_window: int, focal_level: int, focal_factor: int = 2,
                 normalize_modulator: bool = False, use_postln_in_modulation: bool = False):
        super().__init__()
        self.dim, self.focal_level, self.normalize_modulator = dim, focal_level, normalize_modulator
        self.f = nn.Linear(dim, 2 * dim + focal_level + 1)
        self.h = nn.Conv2d(dim, dim, 1)
        self.proj = nn.Linear(dim, dim)
        self.focal_layers = nn.ModuleList()
        for l in range(focal_level):
            k = focal_factor * l + focal_window
            self.focal_layers.append(nn.Sequential(
                nn.Conv2d(dim, dim, k, padding=k // 2, groups=dim, bias=False), nn.GELU()))
        self.ln = nn.LayerNorm(dim, eps=1e-5) if use_postln_in_modulation else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        C, L = self.dim, self.focal_level
        f = self.f(x).permute(0, 3, 1, 2)
        q, ctx, gates = f[:, :C], f[:, C:2 * C], f[:, 2 * C:]
        ctx_all = 0
        for l, layer in enumerate(self.focal_layers):
            ctx = layer(ctx)
            ctx_all = ctx_all + ctx * gates[:, l:l + 1]
        ctx_global = F.gelu(ctx.mean((2, 3), keepdim=True))
        ctx_all = ctx_all + ctx_global * gates[:, L:]
        if self.normalize_modulator:
            ctx_all = ctx_all / (L + 1)
        out = (q * self.h(ctx_all)).permute(0, 2, 3, 1)
        if self.ln is not None:
            out = self.ln(out)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class FocalModulationBlock(nn.Module):
    def __init__(self, dim: int, focal_level: int, focal_window: int, use_postln: bool = False,
                 use_postln_in_modulation: bool = False, normalize_modulator: bool = False,
                 use_layerscale: bool = False, drop_path: float = 0.0, mlp_ratio: float = 4.0):
        super().__init__()
        self.use_postln = use_postln
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.modulation = FocalModulation(dim, focal_window, focal_level,
                                          normalize_modulator=normalize_modulator,
                                          use_postln_in_modulation=use_postln_in_modulation)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if use_layerscale:
            self.gamma_1 = nn.Parameter(torch.full((dim,), 1e-4))
            self.gamma_2 = nn.Parameter(torch.full((dim,), 1e-4))
        else:
            self.gamma_1 = self.gamma_2 = None
        self.drop_path = DropPath(drop_path)

    def _scale(self, gamma, y):
        return y if gamma is None else gamma.to(y.dtype) * y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_postln:
            x = x + self.drop_path(self._scale(self.gamma_1, self.norm1(self.modulation(x))))
            return x + self.drop_path(self._scale(self.gamma_2, self.norm2(self.mlp(x))))
        x = x + self.drop_path(self._scale(self.gamma_1, self.modulation(self.norm1(x))))
        return x + self.drop_path(self._scale(self.gamma_2, self.mlp(self.norm2(x))))


class PatchEmbed(nn.Module):
    """A conv (NCHW in) and a LayerNorm, NHWC out."""

    def __init__(self, cin: int, cout: int, is_stem: bool, use_conv_embed: bool, patch: int = 4):
        super().__init__()
        if use_conv_embed:
            k, s, p = (7, 4, 2) if is_stem else (3, 2, 1)
            self.proj = nn.Conv2d(cin, cout, k, s, p)
        else:
            p = patch if is_stem else 2
            self.proj = SamePadConv2d(cin, cout, p, p)
        self.norm = nn.LayerNorm(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    def __init__(self, blocks, downsample: Optional[PatchEmbed]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class FocalNetFeatures(nn.Module):
    def __init__(self, arch: str, stochastic_depth_prob: Optional[float]):
        super().__init__()
        cfg = ARCH_SETTINGS[arch]
        e, depths = cfg["embed_dim"], cfg["depths"]
        sd = cfg.get("sd", 0.0) if stochastic_depth_prob is None else stochastic_depth_prob
        rates = iter(linear_drop_rates(sd, depths))
        self.patch_embed = PatchEmbed(3, e, True, cfg["conv_embed"])
        layers, dim = [], e
        for s in range(4):
            blocks = [
                FocalModulationBlock(
                    dim, cfg["focal_levels"][s], cfg["focal_windows"][s], use_postln=cfg["postln"],
                    use_postln_in_modulation=cfg.get("postln_in_mod", False),
                    normalize_modulator=cfg["norm_mod"], use_layerscale=cfg["layerscale"],
                    drop_path=next(rates),
                )
                for _ in range(depths[s])
            ]
            down = PatchEmbed(dim, 2 * dim, False, cfg["conv_embed"]) if s < 3 else None
            layers.append(BasicLayer(blocks, down))
            dim *= 2
        self.layers = nn.ModuleList(layers)


class OutputNorms(nn.Module):
    """``norm{idx}``: the LayerNorm of each returned level."""

    def __init__(self, dims: Dict[int, int]):
        super().__init__()
        for idx, d in dims.items():
            self.add_module(f"norm{idx}", nn.LayerNorm(d, eps=1e-5))


class FocalNetBackbone(nn.Sequential):
    weights_prefix = "0."

    def __init__(self, arch: str = "focalnet_large_lrf_fl4", return_indices: Tuple[int, ...] = (1, 2, 3),
                 stochastic_depth_prob: Optional[float] = None):
        e = ARCH_SETTINGS[arch]["embed_dim"]
        dims = {i: e * 2**i for i in return_indices}
        super().__init__(FocalNetFeatures(arch, stochastic_depth_prob), OutputNorms(dims))
        self.return_indices = tuple(return_indices)
        self.num_channels = [dims[i] for i in self.return_indices]

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        body, norms = self[0], self[1]
        x = body.patch_embed(x)
        outputs = {}
        for s, layer in enumerate(body.layers):
            for block in layer.blocks:
                x = block(x)
            if s in self.return_indices:
                outputs[s] = getattr(norms, f"norm{s}")(x).permute(0, 3, 1, 2)
            if layer.downsample is not None:
                x = layer.downsample(x.permute(0, 3, 1, 2))
        return outputs

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initializers: flax's defaults, layer scales 1e-4."""
        flax_default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, FocalModulationBlock) and m.gamma_1 is not None:
                m.gamma_1.fill_(1e-4)
                m.gamma_2.fill_(1e-4)
