"""Swin Transformer backbone family, v1 and v2 (port of
salience_detr_tpu/models/backbones/swin.py).

``forward(images (B, 3, H, W))`` returns {stage_idx: (B, C_i, H/s, W/s)}, the
post-stage (pre-merge) maps; inside, the tokens are NHWC.  Module names are
torchvision's ``SwinTransformer.features`` under the wrapper index ``0``
(upstream wraps the extractor as ``nn.Sequential(fx, PostProcess)``), so
``state_dict()`` keys are the converter's ``backbone.0.features.*``:

* ``features.0``: a 4x4 stride-4 conv ("SAME" padding) and a LayerNorm;
* ``features.{2s+1}``: stage s, a sequence of :class:`SwinBlock`;
* ``features.{2s}`` (s >= 1): :class:`PatchMerging`.

``relative_position_index`` and v2's ``relative_coords_table`` are
non-persistent buffers: the JAX package computes them, so no rule maps them
and a strict load of an export has no such keys (an upstream ``.pth`` has
``attn.relative_position_index``, which the loaders drop by name).

Window attention follows the JAX module: the shift is 0 when one window
covers the map; the map is zero-padded to a multiple of the window after
``norm1``; ``roll(-shift)`` precedes the window split; the additive mask of
the shifted regions is computed on the padded size; logits and softmax are
float32 whatever the compute dtype.  v2: cosine attention with a per-head
``logit_scale`` clamped at log 100, the continuous position bias (an MLP 2 ->
512 -> H in float32 over the log-spaced coordinates, then 16 sigmoid), a qkv
bias whose k third is zero in every forward, post-norm blocks, and patch
merging that reduces first and then normalises over 2C.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from salience_detr_torch.models.layers import (
    DropPath,
    Permute,
    SamePadConv2d,
    attention_f32,
    flax_default_init_,
    linear_drop_rates,
    trunc_normal_002_,
)

ARCH_SETTINGS: Dict[str, Dict] = {
    # sd = the reference registry's stochastic depth
    "swin_t": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window=7, sd=0.2),
    "swin_s": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), window=7, sd=0.3),
    "swin_b": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=7, sd=0.5),
    "swin_l": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window=7, sd=0.2),
    "swin_b_384": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=12, sd=0.2),
    "swin_l_384": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window=12, sd=0.2),
    "swin_v2_t": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window=8, sd=0.2, v2=True),
    "swin_v2_b": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=8, sd=0.5, v2=True),
}


def relative_coords_table(window: int) -> np.ndarray:
    """v2's bias-MLP input: relative coordinates over (w - 1), scaled to
    [-8, 8], sign-log2 compressed; ((2w-1)^2, 2) float32."""
    r = np.arange(-(window - 1), window, dtype=np.float32)
    t = np.stack(np.meshgrid(r, r, indexing="ij"), -1)
    t = t / (window - 1) * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / 3.0
    return t.reshape(-1, 2)


def relative_position_index(window: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask, -100 between tokens of different
    regions of the rolled map, else 0."""
    img = np.zeros((hp, wp))
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(hp // window, window, wp // window, window).transpose(0, 2, 1, 3)
    img = img.reshape(-1, window * window)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mask_on(hp: int, wp: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    """``shifted_window_mask`` on ``device``, copied once per shape."""
    return torch.from_numpy(shifted_window_mask(hp, wp, window, shift)).to(device)


class ShiftedWindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, shift: int, v2: bool = False):
        super().__init__()
        self.dim, self.window, self.num_heads, self.shift, self.v2 = dim, window, num_heads, shift, v2
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window)).reshape(-1), persistent=False)
        if v2:
            self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), float(np.log(10.0))))
            self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(), nn.Linear(512, num_heads, bias=False))
            self.register_buffer("relative_coords_table", torch.from_numpy(relative_coords_table(window)),
                                 persistent=False)
        else:
            self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))

    def position_bias(self) -> torch.Tensor:
        """(H, N, N) float32 additive bias."""
        n = self.window * self.window
        if self.v2:
            with torch.autocast(self.relative_coords_table.device.type, enabled=False):
                table = self.cpb_mlp(self.relative_coords_table)
            bias = 16.0 * torch.sigmoid(table[self.relative_position_index].reshape(n, n, -1))
        else:
            bias = self.relative_position_bias_table[self.relative_position_index].reshape(n, n, -1)
        return bias.float().permute(2, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, shift = self.window, self.shift
        if H <= ws and W <= ws:  # one window covers the map: no shift
            shift = 0
        pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
        xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        if shift > 0:
            xp = torch.roll(xp, (-shift, -shift), dims=(1, 2))
        nh, nw = Hp // ws, Wp // ws
        n = ws * ws
        windows = xp.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, nh * nw, n, C)

        if self.v2:
            b = self.qkv.bias
            qkv = F.linear(windows, self.qkv.weight, torch.cat([b[:C], torch.zeros_like(b[C:2 * C]), b[2 * C:]]))
        else:
            qkv = self.qkv(windows)
        hd = C // self.num_heads
        # (B, windows, H, N, hd) each
        q, k, v = qkv.reshape(B, nh * nw, n, 3, self.num_heads, hd).permute(3, 0, 1, 4, 2, 5)

        attn_bias = self.position_bias()  # (H, N, N), broadcast over the batch and windows
        if shift > 0:
            attn_bias = attn_bias + _mask_on(Hp, Wp, ws, shift, x.device)[:, None]  # (windows, H, N, N)
        if self.v2:
            with torch.autocast(x.device.type, enabled=False):
                qf, kf = q.float(), k.float()
                qn = qf / torch.linalg.vector_norm(qf, dim=-1, keepdim=True).clamp_min(1e-12)
                kn = kf / torch.linalg.vector_norm(kf, dim=-1, keepdim=True).clamp_min(1e-12)
                scale = torch.exp(torch.clamp(self.logit_scale.float(), max=float(np.log(100.0))))
            out = attention_f32(qn, kn, v, attn_bias, scale)
        else:
            out = attention_f32(q, k, v, attn_bias, hd ** -0.5)
        out = self.proj(out.transpose(2, 3).reshape(B, nh * nw, n, C))
        out = out.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        if shift > 0:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        return out[:, :H, :W]


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, drop_path: float = 0.0,
                 v2: bool = False, mlp_ratio: float = 4.0):
        super().__init__()
        self.v2 = v2
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftedWindowAttention(dim, window, num_heads, shift, v2)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0), nn.Linear(hidden, dim),
                                 nn.Dropout(0.0))
        self.stochastic_depth = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.v2:  # post-norm: the norm after each branch
            x = x + self.stochastic_depth(self.norm1(self.attn(x)))
            return x + self.stochastic_depth(self.norm2(self.mlp(x)))
        x = x + self.stochastic_depth(self.attn(self.norm1(x)))
        return x + self.stochastic_depth(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (x0..x3 as the JAX module orders them) to
    4C, then a Linear to 2C (no bias) and a LayerNorm: over 4C before the
    reduction in v1, over 2C after it in v2."""

    def __init__(self, dim: int, v2: bool = False):
        super().__init__()
        self.v2 = v2
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim if v2 else 4 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        if self.v2:
            return self.norm(self.reduction(x))
        return self.reduction(self.norm(x))


class SwinFeatures(nn.Module):
    def __init__(self, arch: str, return_indices: Tuple[int, ...], stochastic_depth_prob: Optional[float]):
        super().__init__()
        cfg = ARCH_SETTINGS[arch]
        e, depths, heads, window = cfg["embed_dim"], cfg["depths"], cfg["num_heads"], cfg["window"]
        v2 = bool(cfg.get("v2", False))
        sd = cfg["sd"] if stochastic_depth_prob is None else stochastic_depth_prob
        rates = iter(linear_drop_rates(sd, depths))
        self.return_indices = tuple(return_indices)
        layers = [nn.Sequential(SamePadConv2d(3, e, 4, 4), Permute(0, 2, 3, 1), nn.LayerNorm(e, eps=1e-5))]
        dim = e
        for s in range(4):
            if s > 0:
                layers.append(PatchMerging(dim, v2))
                dim *= 2
            layers.append(nn.Sequential(*(
                SwinBlock(dim, heads[s], window, 0 if b % 2 == 0 else window // 2, next(rates), v2)
                for b in range(depths[s])
            )))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        outputs = {}
        x = self.features[0](x)
        for s in range(4):
            if s > 0:
                x = self.features[2 * s](x)
            x = self.features[2 * s + 1](x)
            if s in self.return_indices:
                outputs[s] = x.permute(0, 3, 1, 2)
        return outputs


class SwinTransformerBackbone(nn.Sequential):
    weights_prefix = "0."

    def __init__(self, arch: str = "swin_l", return_indices: Tuple[int, ...] = (1, 2, 3),
                 stochastic_depth_prob: Optional[float] = None):
        super().__init__(SwinFeatures(arch, return_indices, stochastic_depth_prob))
        e = ARCH_SETTINGS[arch]["embed_dim"]
        self.return_indices = tuple(return_indices)
        self.num_channels = [e * 2**i for i in self.return_indices]

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        return self[0](x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initializers: flax's defaults (the v2 qkv bias and
        the bias MLP's included), the v1 bias tables truncated normal 0.02,
        v2's logit scale log 10."""
        flax_default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, ShiftedWindowAttention):
                if m.v2:
                    m.logit_scale.fill_(float(np.log(10.0)))
                else:
                    trunc_normal_002_(m.relative_position_bias_table, generator)
