"""Focal-style classification losses (port of salience_detr_tpu/ops/losses.py).

Everything is computed in float32 whatever the input dtype.
``sigmoid_focal_loss`` keeps the gradient through the focal weight;
``vari_sigmoid_focal_loss`` and ``ia_bce_loss`` (which nothing in either
package calls) detach the probability.  ``mask``
(broadcastable to the inputs) zeroes the contributions of padded positions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _normalize(loss: torch.Tensor, num_boxes) -> torch.Tensor:
    """Reference normalisation: (loss.sum(1) / dim1).sum() / num_boxes."""
    n = max(loss.shape[1], 1)
    return (loss.sum(dim=1) / n).sum() / num_boxes


def sigmoid_focal_loss(
    inputs: torch.Tensor,
    targets: torch.Tensor,
    num_boxes,
    alpha: float = 0.25,
    gamma: float = 2.0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    inputs = inputs.float()
    targets = targets.float()
    prob = inputs.sigmoid()
    weight = (1.0 - alpha) * prob**gamma * (1.0 - targets) + targets * alpha * (1.0 - prob) ** gamma
    loss = F.binary_cross_entropy_with_logits(inputs, targets, reduction="none") * weight
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    return _normalize(loss, num_boxes)


def vari_sigmoid_focal_loss(
    inputs: torch.Tensor,
    targets: torch.Tensor,
    gt_score: torch.Tensor,
    num_boxes,
    alpha: float = 0.25,
    gamma: float = 2.0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """IoU-aware (RT-DETR style) focal loss."""
    inputs = inputs.float()
    targets = targets.float()
    prob = inputs.detach().sigmoid()
    target_score = targets * gt_score[..., None].float()
    weight = (1.0 - alpha) * prob**gamma * (1.0 - targets) + target_score
    loss = F.binary_cross_entropy_with_logits(inputs, target_score, reduction="none") * weight
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    return _normalize(loss, num_boxes)


def ia_bce_loss(
    inputs: torch.Tensor,
    targets: torch.Tensor,
    gt_score: torch.Tensor,
    num_boxes,
    k: float = 0.25,
    alpha: float = 0.0,
    gamma: float = 2.0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """IoU-aware BCE loss (Align-DETR, the reference's losses.py:24-33): the
    positive target prob^k * iou^(1-k), at least 0.01, the probability
    detached."""
    inputs = inputs.float()
    targets = targets.float()
    prob = inputs.detach().sigmoid()
    iou_aware_score = (prob**k * gt_score[..., None].float() ** (1.0 - k)).clamp(min=0.01)
    target_score = targets * iou_aware_score
    weight = (1.0 - alpha) * prob**gamma * (1.0 - targets) + targets
    loss = F.binary_cross_entropy_with_logits(inputs, target_score, reduction="none") * weight
    if mask is not None:
        loss = loss * mask.to(loss.dtype)
    return _normalize(loss, num_boxes)
