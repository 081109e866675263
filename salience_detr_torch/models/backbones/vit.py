"""ViT / ViTDet and EVA-02 backbones with the SimpleFeaturePyramid (port of
salience_detr_tpu/models/backbones/vit.py).  No shipped config uses them.

``forward(images (B, 3, H, W))`` returns {stage_idx: (B, out_channels, h, w)}
at stride 4 * 2**idx, built from the stride-16 (patch 16) token map: two 2x
deconvs (index 0), one (index 1), the map itself (index 2), a 2x2 max pool
(index 3), each followed by a 1x1 and a 3x3 conv with LayerNorm and ReLU,
and for index 4 a kernel-1 stride-2 max pool of the previous output.

Upstream wraps ``nn.Sequential(VisionTransformerNoHead, SimpleFeaturePyramid)``,
so ``state_dict()`` keys are the converter's ``backbone.0.conv_proj``,
``backbone.0.encoder.{pos_embedding, layers.encoder_layer_{i}.*, ln}`` and
``backbone.1.stage_{idx+2}.*``.  The learned position table (a g x g grid,
no class-token slot) is resized bilinearly to the token grid with
antialiasing when it shrinks, as ``jax.image.resize`` does.

ViT blocks: windowed or global attention with a merged qkv (``in_proj``),
GELU MLP.  EVA-02 blocks: separate q/k/v projections (standalone q and v
biases), 2D rotary embedding (``rope_tables``: anisotropic axes, consecutive
pairs rotated), SwiGLU with an inner LayerNorm, row-mode stochastic depth
at ``linspace(0, drop_path, depth)``.

The pyramid's transposed convs compute what the JAX module's flax
``ConvTranspose`` computes on the converted weights: torch's transposed conv
with the kernel flipped in both spatial axes (``FlaxConvTranspose2d``).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from salience_detr_torch.models.layers import (
    DropPath,
    LayerNorm2d,
    SamePadConv2d,
    attention_f32,
    flax_default_init_,
    lecun_normal_,
    trunc_normal_002_,
)

ARCH_SETTINGS: Dict[str, Dict] = {
    # pos_grid: the pretrained position table's side (224 / patch)
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, window=14, global_idx=(2, 5, 8, 11), pos_grid=14),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, window=14, global_idx=(5, 11, 17, 23), pos_grid=14),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, window=14, global_idx=(7, 15, 23, 31), patch=14,
                  pos_grid=16),
    # EVA-02: window_idx lists the windowed blocks, the rest attend globally
    "eva_02_vit_b_4attn_1024": dict(
        embed_dim=768, depth=12, num_heads=12, mlp_dim=2048, window=16,
        window_idx=(0, 1, 3, 4, 6, 7, 9, 10), rope=True, swiglu=True, drop_path=0.1, pos_grid=14),
    "eva_02_vit_b_6attn_win32_1536": dict(
        embed_dim=768, depth=12, num_heads=12, mlp_dim=2048, window=32,
        window_idx=(0, 2, 4, 6, 8, 10), rope=True, swiglu=True, drop_path=0.1, pos_grid=14),
    "eva_02_vit_l_4attn_1024": dict(
        embed_dim=1024, depth=24, num_heads=16, mlp_dim=2730, window=16,
        window_idx=(0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 18, 19, 20, 21, 22),
        rope=True, swiglu=True, drop_path=0.4, pos_grid=14),
    "eva_02_vit_l_8attn_1536": dict(
        embed_dim=1024, depth=24, num_heads=16, mlp_dim=2730, window=16,
        window_idx=(0, 1, 3, 4, 6, 7, 9, 10, 12, 13, 15, 16, 18, 19, 21, 22),
        rope=True, swiglu=True, drop_path=0.3, pos_grid=14),
    "eva_02_vit_l_8attn_win32_1536": dict(
        embed_dim=1024, depth=24, num_heads=16, mlp_dim=2730, window=32,
        window_idx=(0, 1, 3, 4, 6, 7, 9, 10, 12, 13, 15, 16, 18, 19, 21, 22),
        rope=True, swiglu=True, drop_path=0.4, pos_grid=14),
}


def rope_tables(hh: int, ww: int, head_dim: int, pt_seq_len: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin), each (hh * ww, head_dim) float32: per-axis frequencies
    over half the head dim, y normalised by hh and x by ww to the pretrain
    grid, each frequency repeated for a consecutive pair."""
    dim = head_dim // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    ty = np.arange(hh, dtype=np.float64) / hh * pt_seq_len
    tx = np.arange(ww, dtype=np.float64) / ww * pt_seq_len
    t = np.stack([np.broadcast_to(ty[:, None], (hh, ww)), np.broadcast_to(tx[None, :], (hh, ww))], -1)
    fr = np.repeat(t[..., None] * freqs, 2, axis=-1).reshape(hh * ww, 2 * dim)
    return np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rope_on(hh: int, ww: int, head_dim: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    cos, sin = rope_tables(hh, ww, head_dim)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Consecutive pairs (x1, x2) -> (-x2, x1)."""
    x = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-x[..., 1], x[..., 0]], -1).flatten(-2)


def apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t (N, H, L, hd), tables (L, hd); in float32, back to t's dtype."""
    tf = t.float()
    return (tf * cos + rotate_half(tf) * sin).to(t.dtype)


def window_partition(y: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * windows, ws * ws, C), zero-padded to a multiple
    of ``ws``; and the padded size."""
    B, H, W, C = y.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    yp = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    t = yp.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, C), (Hp, Wp)


def window_unpartition(t: torch.Tensor, ws: int, padded, B: int, H: int, W: int) -> torch.Tensor:
    Hp, Wp = padded
    C = t.shape[-1]
    t = t.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, Hp, Wp, C)[:, :H, :W]


class MergedSelfAttention(nn.Module):
    """ViT attention with torchvision's merged ``in_proj`` and ``out_proj``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # (N, L, C)
        N, L, C = tokens.shape
        hd = C // self.num_heads
        q, k, v = F.linear(tokens, self.in_proj_weight, self.in_proj_bias).reshape(
            N, L, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        out = attention_f32(q, k, v, None, hd ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(N, L, C))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.window = window
        self.ln_1 = nn.LayerNorm(dim, eps=1e-6)
        self.self_attention = MergedSelfAttention(dim, num_heads)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0), nn.Linear(hidden, dim),
                                 nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        B, H, W, C = x.shape
        y = self.ln_1(x)
        if self.window > 0:
            tokens, padded = window_partition(y, self.window)
            out = window_unpartition(self.self_attention(tokens), self.window, padded, B, H, W)
        else:
            out = self.self_attention(y.reshape(B, H * W, C)).reshape(B, H, W, C)
        x = x + out
        return x + self.mlp(self.ln_2(x))


class EVASelfAttention(nn.Module):
    """Separate q/k/v projections without bias, standalone q and v biases
    (k has none), rotary q and k."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    def forward(self, tokens: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        N, L, C = tokens.shape
        hd = C // self.num_heads

        def heads(t):
            return t.reshape(N, L, self.num_heads, hd).transpose(1, 2)

        q = heads(F.linear(tokens, self.q_proj.weight, self.q_bias))
        k = heads(self.k_proj(tokens))
        v = heads(F.linear(tokens, self.v_proj.weight, self.v_bias))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = attention_f32(q, k, v, None, hd ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(N, L, C))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(dim, hidden)
        self.ffn_ln = nn.LayerNorm(hidden, eps=1e-6)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class EVABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, window: int, drop_path: float = 0.0):
        super().__init__()
        self.window = window
        self.ln_1 = nn.LayerNorm(dim, eps=1e-6)
        self.self_attention = EVASelfAttention(dim, num_heads)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = SwiGLU(dim, mlp_dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        y = self.ln_1(x)
        if self.window > 0:
            tokens, padded = window_partition(y, self.window)
            out = window_unpartition(self.self_attention(tokens, cos, sin), self.window, padded, B, H, W)
        else:
            out = self.self_attention(y.reshape(B, H * W, C), cos, sin).reshape(B, H, W, C)
        x = x + self.drop_path(out)
        return x + self.drop_path(self.mlp(self.ln_2(x)))


class Encoder(nn.Module):
    def __init__(self, cfg: Dict, C: int):
        super().__init__()
        g = cfg["pos_grid"]
        self.pos_embedding = nn.Parameter(torch.zeros(1, g * g, C))
        self.layers = nn.Module()
        dpr = np.linspace(0, cfg.get("drop_path", 0.0), cfg["depth"])
        for i in range(cfg["depth"]):
            if cfg.get("rope"):
                window = cfg["window"] if i in cfg["window_idx"] else 0
                block = EVABlock(C, cfg["num_heads"], cfg["mlp_dim"], window, float(dpr[i]))
            else:
                block = ViTBlock(C, cfg["num_heads"], 0 if i in cfg["global_idx"] else cfg["window"])
            self.layers.add_module(f"encoder_layer_{i}", block)
        self.ln = nn.LayerNorm(C, eps=1e-6)


class VisionTransformerNoHead(nn.Module):
    def __init__(self, arch: str):
        super().__init__()
        self.cfg = cfg = ARCH_SETTINGS[arch]
        C, patch = cfg["embed_dim"], cfg.get("patch", 16)
        self.conv_proj = SamePadConv2d(3, C, patch, patch)
        self.encoder = Encoder(cfg, C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> the normed stride-``patch`` token map (B, h, w, C)."""
        cfg = self.cfg
        x = self.conv_proj(x).permute(0, 2, 3, 1)
        B, H, W, C = x.shape
        g = cfg["pos_grid"]
        pos = self.encoder.pos_embedding.reshape(1, g, g, C).permute(0, 3, 1, 2)
        pos = F.interpolate(pos, (H, W), mode="bilinear", align_corners=False, antialias=True)
        x = x + pos.permute(0, 2, 3, 1).to(x.dtype)
        if cfg.get("rope"):
            hd = C // cfg["num_heads"]
            ws = cfg["window"]
            cos_w, sin_w = _rope_on(ws, ws, hd, x.device)
            cos_g, sin_g = _rope_on(H, W, hd, x.device)
            for block in self.encoder.layers.children():
                x = block(x, cos_w, sin_w) if block.window > 0 else block(x, cos_g, sin_g)
        else:
            for block in self.encoder.layers.children():
                x = block(x)
        return self.encoder.ln(x)


class FlaxConvTranspose2d(nn.ConvTranspose2d):
    """A 2x2 stride-2 transposed conv computed as the JAX module's flax
    ``ConvTranspose`` (no ``transpose_kernel``) computes it on the converted
    weights: torch's transposed conv with the kernel flipped in both spatial
    axes (ROADMAP C-22)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.flip(2, 3), self.bias, self.stride)


def conv_norm_act(cin: int, cout: int, kernel: int) -> nn.Sequential:
    """Conv (no bias) -> channels LayerNorm -> ReLU."""
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False),
                         LayerNorm2d(cout, eps=1e-6), nn.ReLU())


class MaxPool2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, 2, 2)


class SimpleFeaturePyramid(nn.Module):
    def __init__(self, C: int, out_channels: int, return_indices: Tuple[int, ...]):
        super().__init__()
        self.return_indices = tuple(return_indices)
        for idx in self.return_indices:
            if idx == 4:
                continue
            if idx == 0:
                head = [FlaxConvTranspose2d(C, C // 2, 2, 2), LayerNorm2d(C // 2, eps=1e-6), nn.GELU(),
                        FlaxConvTranspose2d(C // 2, C // 4, 2, 2)]
                cin = C // 4
            elif idx == 1:
                head, cin = [FlaxConvTranspose2d(C, C // 2, 2, 2)], C // 2
            elif idx == 2:
                head, cin = [], C
            else:
                head, cin = [MaxPool2()], C
            self.add_module(f"stage_{idx + 2}", nn.Sequential(
                *head, conv_norm_act(cin, out_channels, 1), conv_norm_act(out_channels, out_channels, 3)))

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:  # x (B, C, h, w)
        outputs = {}
        for idx in sorted(self.return_indices):
            if idx == 4:
                prev = max(i for i in self.return_indices if i < 4)
                outputs[4] = F.max_pool2d(outputs[prev], 1, 2)
            else:
                outputs[idx] = getattr(self, f"stage_{idx + 2}")(x)
        return outputs


class VisionTransformerBackbone(nn.Sequential):
    weights_prefix = "0."

    def __init__(self, arch: str = "vit_b", return_indices: Tuple[int, ...] = (1, 2, 3), out_channels: int = 256):
        C = ARCH_SETTINGS[arch]["embed_dim"]
        super().__init__(VisionTransformerNoHead(arch), SimpleFeaturePyramid(C, out_channels, return_indices))
        self.return_indices = tuple(return_indices)
        self.num_channels = [out_channels] * len(self.return_indices)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        return self[1](self[0](x).permute(0, 3, 1, 2))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initializers: flax's defaults (the merged qkv
        too), EVA-02's q/k/v Xavier-uniform, the position table truncated
        normal 0.02."""
        flax_default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, MergedSelfAttention):
                lecun_normal_(m.in_proj_weight, generator)
                nn.init.zeros_(m.in_proj_bias)
            elif isinstance(m, EVASelfAttention):
                for proj in (m.q_proj, m.k_proj, m.v_proj):
                    nn.init.xavier_uniform_(proj.weight, generator=generator)
                nn.init.zeros_(m.q_bias)
                nn.init.zeros_(m.v_bias)
        trunc_normal_002_(self[0].encoder.pos_embedding, generator)
