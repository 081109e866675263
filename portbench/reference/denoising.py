"""Contrastive denoising (CDN) queries (port of salience_detr_tpu/models/bricks/denoising.py).

The slot layout is the JAX package's: a static capacity of
``2 * denoising_nums`` slots, [g0_pos(m) | g0_neg(m) | g1_pos | ...], where
m is the batch's largest gt count (capped at ``denoising_nums``) and
g = max(denoising_nums // m, 1) the group count; slots beyond 2 * g * m are
dead: zero queries that see only themselves.  Here m and g are host
integers, taken from the targets' per-image gt counts before the batch
reaches the device, so the layout costs no synchronisation.

The random draws (label flips, random labels, box-noise signs and parts) are
a :class:`CDNDraws` argument, made by :func:`cdn_draws` from an explicit
``torch.Generator``; a test can pass in draws made by ``jax.random`` instead.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn

from portbench.reference.boxes import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh
from portbench.reference.misc import inverse_sigmoid


class CDNDraws(NamedTuple):
    flip: torch.Tensor  # (B, NDN) bool: replace the label
    rand_labels: torch.Tensor  # (B, NDN) int: the replacement label
    sign: torch.Tensor  # (B, NDN, 4) float in {-1, +1}
    part: torch.Tensor  # (B, NDN, 4) float uniform [0, 1)


def cdn_draws(batch: int, capacity: int, num_classes: int, label_noise_prob: float,
              generator: torch.Generator, device) -> CDNDraws:
    """The draws of one CDN generation; label noise at prob * 0.5
    (the reference's denoising.py:272)."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    flip = rand(batch, capacity) < label_noise_prob * 0.5
    rand_labels = torch.randint(0, num_classes, (batch, capacity), generator=generator, device=device)
    sign = torch.randint(0, 2, (batch, capacity, 4), generator=generator, device=device).float() * 2 - 1
    return CDNDraws(flip, rand_labels, sign, rand(batch, capacity, 4))


def rows_of(draws: CDNDraws, offset: int, count: int) -> CDNDraws:
    """Rows [offset, offset + count) of draws made for a larger batch: a
    rank of a data-parallel step draws at the global batch's shape from the
    generator every rank seeds alike, and keeps its rows, so each image gets
    the noise it gets in one process on the whole batch."""
    return CDNDraws(*(x[offset:offset + count] for x in draws))


def cdn_meta(counts: Sequence[int], denoising_nums: int) -> Tuple[int, int]:
    """(m, g) from the per-image valid gt counts: m = max count capped at
    ``denoising_nums``, g = max(denoising_nums // m, 1)."""
    m = min(max(counts, default=0), denoising_nums)
    g = max(denoising_nums * m // max(m * m, 1), 1)
    return m, g


def cdn_slot_layout(m: int, g: int, capacity: int, device):
    """Per slot: (gt index (NDN,), is_negative (NDN,), live (NDN,)), live
    marking slots below 2 * g * m."""
    m0 = max(m, 1)
    idx = torch.arange(capacity, device=device)
    blk = idx // (2 * m0)
    within = idx - blk * (2 * m0)
    is_neg = within >= m0
    t = torch.where(is_neg, within - m0, within)
    live = (blk < g) & (m > 0)
    return t, is_neg, live


def cdn_attn_mask(m: int, g: int, capacity: int, num_queries: int, device) -> torch.Tensor:
    """(capacity + num_queries,)^2 bool, True = BLOCKED: groups see only
    themselves, matching queries see no CDN slot, dead slots see only
    themselves and are seen by nothing else."""
    m0 = max(m, 1)
    idx = torch.arange(capacity, device=device)
    blk = idx // (2 * m0)
    dead = idx >= 2 * g * m0
    blocked = (blk[:, None] != blk[None, :]) | dead[None, :] | dead[:, None]
    blocked &= ~torch.eye(capacity, dtype=torch.bool, device=device)
    total = capacity + num_queries
    mask = torch.zeros(total, total, dtype=torch.bool, device=device)
    mask[:capacity, :capacity] = blocked
    mask[capacity:, :capacity] = True
    return mask


def cdn_box_noise(boxes_r: torch.Tensor, sign: torch.Tensor, part: torch.Tensor,
                  is_negative: torch.Tensor, box_noise_scale: float) -> torch.Tensor:
    """Contrastive box noise on normalised cxcywh boxes: half-extent shifts of
    the xyxy corners, positives scaled by U[0, 1), negatives by U[1, 2), a
    random sign, clamped to [0, 1], back to cxcywh."""
    diff = torch.cat([boxes_r[..., 2:] / 2, boxes_r[..., 2:] / 2], -1)
    part = part + is_negative.to(part.dtype)
    xyxy = box_cxcywh_to_xyxy(boxes_r)
    xyxy = (xyxy + part * sign * diff * box_noise_scale).clamp(0.0, 1.0)
    return box_xyxy_to_cxcywh(xyxy)


def cdn_match_indices(m: int, g: int, denoising_nums: int, device):
    """(query_idx, gt_idx, pair_live), each (denoising_nums,): the positives
    of each live group match the gt slots in order."""
    m0 = max(m, 1)
    p = torch.arange(denoising_nums, device=device)
    grp = p // m0
    t = p - grp * m0
    return grp * (2 * m0) + t, t, (grp < g) & (m > 0)


class GenerateCDNQueries(nn.Module):
    """Noised label and box queries over the static slot capacity."""

    def __init__(self, num_classes: int = 91, label_embed_dim: int = 256,
                 denoising_nums: int = 100, label_noise_prob: float = 0.5,
                 box_noise_scale: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.denoising_nums = denoising_nums
        self.label_noise_prob = label_noise_prob
        self.box_noise_scale = box_noise_scale
        self.label_encoder = nn.Embedding(num_classes, label_embed_dim)

    @property
    def num_denoising_queries(self) -> int:
        return 2 * self.denoising_nums

    def forward(self, gt_labels: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                m: int, g: int, draws: CDNDraws) -> Tuple[torch.Tensor, torch.Tensor]:
        """gt_labels (B, M) int, gt_boxes (B, M, 4) normalised cxcywh,
        gt_valid (B, M) bool with the valid gts first -> (label queries
        (B, NDN, C), box queries (B, NDN, 4) as logits), zero in dead slots."""
        M = gt_labels.shape[1]
        t, is_neg, live = cdn_slot_layout(m, g, self.num_denoising_queries, gt_labels.device)
        n_per_image = gt_valid.sum(1)
        t_c = t.clamp(0, M - 1)
        labels = gt_labels[:, t_c]  # (B, NDN)
        boxes = gt_boxes.float()[:, t_c]  # (B, NDN, 4)
        valid = (live[None] & (t[None] < n_per_image[:, None]))[..., None]

        noised_labels = torch.where(draws.flip, draws.rand_labels, labels)
        noised_boxes = cdn_box_noise(
            boxes, draws.sign, draws.part, is_neg[None, :, None], self.box_noise_scale
        )
        noised_boxes = inverse_sigmoid(noised_boxes)
        label_query = self.label_encoder(noised_labels.clamp(0, self.num_classes - 1))
        return (
            torch.where(valid, label_query, torch.zeros_like(label_query)),
            torch.where(valid, noised_boxes, torch.zeros_like(noised_boxes)),
        )
