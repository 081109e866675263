"""Detection post-processing (port of salience_detr_tpu/models/bricks/post_process.py,
with the optional confidence and NMS filters off): flat top-k over
(num_queries x num_classes) sigmoid scores, label = index % num_classes,
cxcywh -> xyxy scaled to the original image size."""

from __future__ import annotations

from typing import Dict

import torch

from salience_detr_torch.ops.boxes import box_cxcywh_to_xyxy
from salience_detr_torch.ops.misc import stable_topk


class PostProcess:
    def __init__(self, select_box_nums_for_evaluation: int = 300):
        self.select_box_nums_for_evaluation = select_box_nums_for_evaluation

    def __call__(
        self,
        pred_logits: torch.Tensor,  # (B, Q, C)
        pred_boxes: torch.Tensor,  # (B, Q, 4) normalized cxcywh
        target_sizes: torch.Tensor,  # (B, 2) original (h, w)
    ) -> Dict[str, torch.Tensor]:
        B, Q, C = pred_logits.shape
        prob = pred_logits.float().sigmoid().reshape(B, Q * C)
        scores, topk_indexes = stable_topk(prob, min(self.select_box_nums_for_evaluation, Q * C))
        topk_boxes = torch.div(topk_indexes, C, rounding_mode="floor")
        labels = topk_indexes % C
        boxes = box_cxcywh_to_xyxy(pred_boxes.float())
        boxes = boxes.gather(1, topk_boxes[..., None].expand(-1, -1, 4))
        img_h = target_sizes[:, 0].float()
        img_w = target_sizes[:, 1].float()
        scale = torch.stack([img_w, img_h, img_w, img_h], -1)[:, None, :]
        return {"scores": scores, "labels": labels, "boxes": boxes * scale}
