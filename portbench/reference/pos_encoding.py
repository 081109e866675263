"""Sine position embeddings (port of salience_detr_tpu/ops/pos_encoding.py).

Outputs are channel-last, as in the JAX package.
"""

from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, temperature: float, device) -> torch.Tensor:
    exponent = 2.0 * torch.div(
        torch.arange(num_pos_feats, device=device), 2, rounding_mode="floor"
    ).float() / num_pos_feats
    return torch.pow(float(temperature), exponent)


def _interleave_sin_cos(x: torch.Tensor) -> torch.Tensor:
    """stack(sin(x[..., 0::2]), cos(x[..., 1::2])).flatten(-2)."""
    return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()], dim=-1).flatten(-2)


def sine_position_embedding(
    padding_mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2.0 * math.pi,
    eps: float = 1e-6,
    offset: float = 0.0,
) -> torch.Tensor:
    """DETR sine embedding over a padding mask (True = padding).

    padding_mask: (B, H, W) bool -> (B, H, W, 2*num_pos_feats) float32.
    """
    not_mask = (~padding_mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, :, -1:] + eps) * scale
    else:
        y_embed = y_embed + offset
        x_embed = x_embed + offset
    dim_t = _dim_t(num_pos_feats, temperature, padding_mask.device)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def get_sine_pos_embed(
    pos_tensor: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    scale: float = 2.0 * math.pi,
    exchange_xy: bool = True,
) -> torch.Tensor:
    """Sine embedding of coordinates (..., D) -> (..., D*num_pos_feats); with
    exchange_xy an (x, y, ...) input yields [emb(y), emb(x), ...]."""
    dim_t = _dim_t(num_pos_feats, temperature, pos_tensor.device)
    pos_res = _interleave_sin_cos(pos_tensor[..., None].float() * scale / dim_t)
    if exchange_xy and pos_res.shape[-2] >= 2:
        order = [1, 0] + list(range(2, pos_res.shape[-2]))
        pos_res = pos_res[..., order, :]
    return pos_res.flatten(-2)
