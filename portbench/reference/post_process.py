"""Detection post-processing (port of salience_detr_tpu/models/bricks/post_process.py):
flat top-k over (num_queries x num_classes) sigmoid scores, label = index %
num_classes, cxcywh -> xyxy scaled to the original image size, and the
optional confidence and NMS filters as a ``valid`` mask (shapes stay fixed):
the confidence filter applies when ``confidence_score > 0``, the
class-agnostic greedy NMS on the scaled top-k boxes (one ``nms_keep_mask``
call for the batch) when ``nms_iou_threshold > 0``; and
``SegmentationPostProcess``, query masks to a per-pixel class map."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference.boxes import box_cxcywh_to_xyxy
from portbench.reference.choices import topk


class PostProcess:
    def __init__(
        self,
        select_box_nums_for_evaluation: int = 300,
        nms_iou_threshold: float = -1.0,
        confidence_score: float = -1.0,
    ):
        self.select_box_nums_for_evaluation = select_box_nums_for_evaluation
        self.nms_iou_threshold = nms_iou_threshold
        self.confidence_score = confidence_score

    def __call__(
        self,
        pred_logits: torch.Tensor,  # (B, Q, C)
        pred_boxes: torch.Tensor,  # (B, Q, 4) normalized cxcywh
        target_sizes: torch.Tensor,  # (B, 2) original (h, w)
    ) -> Dict[str, torch.Tensor]:
        B, Q, C = pred_logits.shape
        prob = pred_logits.float().sigmoid().reshape(B, Q * C)
        scores, topk_indexes = topk("post", prob, min(self.select_box_nums_for_evaluation, Q * C))
        topk_boxes = torch.div(topk_indexes, C, rounding_mode="floor")
        labels = topk_indexes % C
        boxes = box_cxcywh_to_xyxy(pred_boxes.float())
        boxes = boxes.gather(1, topk_boxes[..., None].expand(-1, -1, 4))
        img_h = target_sizes[:, 0].float()
        img_w = target_sizes[:, 1].float()
        scale = torch.stack([img_w, img_h, img_w, img_h], -1)[:, None, :]
        boxes = boxes * scale

        valid = torch.ones_like(scores, dtype=torch.bool)
        if self.confidence_score > 0:
            # the JAX package compares against the threshold in float32
            valid &= scores > float(np.float32(self.confidence_score))
        if self.nms_iou_threshold > 0:
            raise NotImplementedError("the reference has no post-process NMS")
        return {"scores": scores, "labels": labels, "boxes": boxes, "valid": valid}


class SegmentationPostProcess:
    """Query masks -> a per-pixel class map (the port of the JAX package's
    ``SegmentationPostProcess``, the functional equivalent of the
    reference's unused one): each query takes its argmax class, the queries
    of a class are averaged into one sigmoid mask (an empty class's mask is
    zero), the per-class stack is resized bilinearly to ``target_hw`` and
    argmaxed over the classes.

    The resize is ``jax.image.resize(method="bilinear")``'s: half-pixel
    centres, the triangle kernel widened by the scale where it shrinks
    (anti-aliasing) and renormalised at the borders, which is
    ``F.interpolate(..., mode="bilinear", align_corners=False,
    antialias=True)``.  Both argmaxes take the first of equal values, as
    ``jnp.argmax`` does."""

    def __call__(
        self,
        pred_logits: torch.Tensor,  # (B, Q, C)
        pred_masks: torch.Tensor,  # (B, Q, h, w)
        target_hw,  # (H, W) output size
    ) -> torch.Tensor:
        B, Q, C = pred_logits.shape
        onehot = torch.nn.functional.one_hot(pred_logits.argmax(-1), C).float()  # (B, Q, C)
        masks = pred_masks.float().sigmoid()
        num = torch.einsum("bqc,bqhw->bchw", onehot, masks)
        den = onehot.sum(1).clamp_min(1.0)[..., None, None]
        per_class = torch.nn.functional.interpolate(num / den, size=tuple(int(n) for n in target_hw),
                                                    mode="bilinear", align_corners=False, antialias=True)
        return per_class.argmax(1)  # (B, H, W)
