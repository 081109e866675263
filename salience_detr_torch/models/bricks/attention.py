"""Attention bricks (port of salience_detr_tpu/models/bricks/attention.py):
multi-scale deformable attention with G location groups, and dense
multi-head attention."""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from salience_detr_torch.ops.deform_attn import compute_sampling_locations, ms_deform_attn, ms_deform_attn_q8


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


class MultiScaleDeformableAttention(nn.Module):
    """Deformable attention with ``sampling_groups`` = G location groups, each
    shared by H/G heads: G = 1 is head-shared sampling, G = H the reference's
    exact per-head sampling.  The sampling runs in the MSDA kernel
    (ops/deform_attn.ms_deform_attn) for every G, or, at G = 1 in eval mode
    with ``MSDA_GATHER_QUANT=int8``, in the int8 core
    (ops/deform_attn.ms_deform_attn_q8), as in the JAX package."""

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

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        reference_points: torch.Tensor,  # (B, Q, L, 2) or (B, Q, L, 4)
        value: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[Tuple[int, int]],
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = padding
    ) -> torch.Tensor:
        B, Q, _ = query.shape
        H, L, P, G = self.num_heads, self.num_levels, self.num_points, self.sampling_groups
        value = self.value_proj(value)
        if key_padding_mask is not None:
            value = value.masked_fill(key_padding_mask[..., None], 0.0)
        offsets = self.sampling_offsets(query).reshape(B, Q, G, L, P, 2)
        logits = self.attention_weights(query).reshape(B, Q, H, L * P)
        weights = logits.float().softmax(-1).to(logits.dtype).reshape(B, Q, H, L, P)
        locations = compute_sampling_locations(
            reference_points.float(), offsets.float(), spatial_shapes, P
        )
        # the JAX package's switch, read at call time as the JAX module reads
        # it at trace time; training and G > 1 are never quantised
        if G == 1 and not self.training and os.environ.get("MSDA_GATHER_QUANT", "none") == "int8":
            out = ms_deform_attn_q8(value, spatial_shapes, locations[:, :, 0], weights)
        else:
            out = ms_deform_attn(value.contiguous(), spatial_shapes, locations, weights)
        return self.output_proj(out)


class MultiheadAttention(nn.Module):
    """Dense multi-head attention with torch ``nn.MultiheadAttention``'s
    parameter names (merged ``in_proj``), computed by SDPA.  The JAX package
    computes this attention outside any kernel, as XLA ops.

    ``attn_mask`` has the JAX package's polarity: True means BLOCKED (the
    JAX code fills those logits with -1e30), shape (Q, K) or (B, Q, K).  It is
    inverted once here for SDPA, whose boolean mask means attend.  Every row
    must keep at least one key: the CDN mask lets each dead slot see itself.

    Under ``torch.use_deterministic_algorithms`` SDPA runs its math
    formulation (two matmuls around a softmax, and their autograd): the
    fused kernels' backward (flash, memory-efficient, cuDNN) adds in no
    fixed order unless the setting raises rather than warns.
    """

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, Q, C = query.shape
        H = self.num_heads
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            return F.linear(x, w, b).reshape(B, -1, H, C // H).transpose(1, 2)

        attend = None
        if attn_mask is not None:
            attend = ~(attn_mask[:, None] if attn_mask.dim() == 3 else attn_mask)
        args = (heads(query, w_q, b_q), heads(key, w_k, b_k), heads(value, w_v, b_v))
        if torch.are_deterministic_algorithms_enabled():
            with sdpa_kernel(SDPBackend.MATH):
                out = F.scaled_dot_product_attention(*args, attn_mask=attend)
        else:
            out = F.scaled_dot_product_attention(*args, attn_mask=attend)
        return self.out_proj(out.transpose(1, 2).reshape(B, Q, C))
