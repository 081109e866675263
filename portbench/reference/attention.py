"""Attention bricks of the reference, in plain float32 PyTorch.

Multi-scale deformable attention with G location groups is upstream's
``multi_scale_deformable_attn_pytorch``: one ``F.grid_sample`` a level
(bilinear, zero padding, ``align_corners=False``, so a location x in [0, 1]
samples pixel x * w - 0.5), the corners weighted by the softmaxed attention
weights.  Dense multi-head attention is two matmuls around a softmax, the
mask's True meaning blocked.  Parameter names are the program's, so one state
dict loads into both."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def offset_bias_grid(num_groups: int, num_levels: int, num_points: int) -> np.ndarray:
    """Directional init of the sampling-offset bias, flattened as the Linear's
    (G, L, P, 2) output.  G = 1 fans the P points over P directions; G > 1 is
    the reference's star over the G location groups, point i at radius i + 1."""
    if num_groups == 1:
        thetas = np.arange(num_points, dtype=np.float64) * (2.0 * math.pi / num_points)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (P, 2)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        return np.tile(grid[None, None], (1, num_levels, 1, 1)).reshape(-1)
    thetas = np.arange(num_groups, dtype=np.float64) * (2.0 * math.pi / num_groups)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (G, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    grid *= np.arange(1, num_points + 1, dtype=np.float64)[None, None, :, None]
    return grid.reshape(-1)


def sampling_locations(reference_points: torch.Tensor, offsets: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]], num_points: int) -> torch.Tensor:
    """reference_points (B, Q, L, 2) points or (B, Q, L, 4) boxes; offsets
    (B, Q, G, L, P, 2) -> locations (B, Q, G, L, P, 2) in [0, 1] (x, y)."""
    if reference_points.shape[-1] == 2:
        wh = torch.tensor([(w, h) for h, w in spatial_shapes], dtype=offsets.dtype, device=offsets.device)
        return reference_points[:, :, None, :, None, :] + offsets / wh[:, None, :]
    return (reference_points[:, :, None, :, None, :2]
            + offsets / num_points * reference_points[:, :, None, :, None, 2:] * 0.5)


def msda_grid_sample(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                     locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """value (B, S, C); locations (B, Q, G, L, P, 2); weights (B, Q, H, L, P)
    -> (B, Q, C): per level one ``grid_sample`` of the (B * H, D, h, w) map at
    each head's group's locations."""
    B, S, C = value.shape
    _, Q, G, L, P, _ = locations.shape
    H = weights.shape[2]
    D = C // H
    loc = locations[:, :, torch.arange(H, device=value.device) * G // H]  # (B, Q, H, L, P, 2)
    grid = 2.0 * loc - 1.0
    sampled, start = [], 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].reshape(B, h * w, H, D).permute(0, 2, 3, 1).reshape(B * H, D, h, w)
        g = grid[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * H, Q, P, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
        start += h * w
    stacked = torch.stack(sampled, -2).flatten(-2)  # (B * H, D, Q, L * P)
    attn = weights.permute(0, 2, 1, 3, 4).reshape(B * H, 1, Q, L * P)
    out = (stacked * attn).sum(-1)  # (B * H, D, Q)
    return out.reshape(B, H * D, Q).transpose(1, 2)


class MultiScaleDeformableAttention(nn.Module):
    """Deformable attention with ``sampling_groups`` = G location groups, each
    shared by H / G heads (G = 1 head-shared, G = H exact per-head sampling)."""

    def __init__(self, embed_dim: int = 256, num_levels: int = 4, num_heads: int = 8,
                 num_points: int = 4, sampling_groups: int = 8):
        super().__init__()
        G = sampling_groups
        assert 1 <= G <= num_heads and num_heads % G == 0, (G, num_heads)
        self.embed_dim, self.num_levels = embed_dim, num_levels
        self.num_heads, self.num_points, self.sampling_groups = num_heads, num_points, G
        self.sampling_offsets = nn.Linear(embed_dim, G * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(embed_dim, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, reference_points, value, spatial_shapes, key_padding_mask=None):
        B, Q, _ = query.shape
        H, L, P, G = self.num_heads, self.num_levels, self.num_points, self.sampling_groups
        value = self.value_proj(value)
        if key_padding_mask is not None:
            value = value.masked_fill(key_padding_mask[..., None], 0.0)
        offsets = self.sampling_offsets(query).reshape(B, Q, G, L, P, 2)
        weights = self.attention_weights(query).reshape(B, Q, H, L * P).softmax(-1).reshape(B, Q, H, L, P)
        locations = sampling_locations(reference_points, offsets, spatial_shapes, P)
        return self.output_proj(msda_grid_sample(value, spatial_shapes, locations, weights))


class MultiheadAttention(nn.Module):
    """Dense multi-head attention with a merged ``in_proj``; ``attn_mask``
    (Q, K) or (B, Q, K), True = blocked."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, attn_mask: Optional[torch.Tensor] = None):
        B, Q, C = query.shape
        H = self.num_heads
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            return F.linear(x, w, b).reshape(B, -1, H, C // H).transpose(1, 2)

        q, k, v = heads(query, w_q, b_q), heads(key, w_k, b_k), heads(value, w_v, b_v)
        logits = q @ k.transpose(-1, -2) / math.sqrt(C // H)
        if attn_mask is not None:
            blocked = attn_mask[:, None] if attn_mask.dim() == 3 else attn_mask
            logits = logits.masked_fill(blocked, float("-inf"))
        out = logits.softmax(-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, Q, C))
