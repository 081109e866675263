"""SalienceDETR detector, eval and train forward, and its loss (port of
salience_detr_tpu/models/detectors/salience_detr.py).

Input contract, as in the JAX package with NCHW images:
* images: (B, 3, H, W) float, normalized and padded to the canvas;
* image_sizes: (B, 2) int valid (h, w); every mask derives from it;
* targets (train): a padded ``criterion.Targets``, with the contrastive-
  denoising draws (``denoising.CDNDraws``) for the batch.  In a
  data-parallel step the CDN group shape (m, g) comes from the global
  batch's gt counts (``targets.shard``), so every rank builds the queries
  and the attention mask of one process on the whole batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from portbench.reference.criterion import (
    SalienceCriterion,
    SetCriterion,
    Targets,
    default_weight_dict,
    global_counts,
)
from portbench.reference.denoising import (
    CDNDraws,
    GenerateCDNQueries,
    cdn_attn_mask,
    cdn_match_indices,
    cdn_meta,
)
from portbench.reference.transformer import SalienceTransformer
from portbench.reference import misc as misc_ops
from portbench.reference.pos_encoding import sine_position_embedding
from portbench.reference.misc import scope

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class SalienceDETR(nn.Module):
    """Backbone + ChannelMapper + SalienceTransformer."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, transformer: SalienceTransformer,
                 num_classes: int = 91, denoising_nums: int = 100):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.transformer = transformer
        self.denoising_nums = denoising_nums
        self.denoising_generator = GenerateCDNQueries(
            num_classes, transformer.embed_dim, denoising_nums
        )

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                targets: Optional[Targets] = None,
                draws: Optional[CDNDraws] = None) -> Dict[str, Any]:
        """Eval forward without targets; with targets and draws, the train
        forward, whose decoder outputs split into the CDN slots (``dn_*``)
        and the matching queries (``pred_*``)."""
        canvas = tuple(images.shape[-2:])
        feats = self.neck(self.backbone(images))  # [(B, C, h, w)]
        with scope("masks_pos_embeds"):
            shapes = [tuple(f.shape[-2:]) for f in feats]
            valid_hw = misc_ops.multi_level_valid_sizes(image_sizes, canvas, shapes)
            masks = [misc_ops.rect_mask(v, s) for v, s in zip(valid_hw, shapes)]
            pos_embeds = [
                sine_position_embedding(
                    m, num_pos_feats=self.transformer.embed_dim // 2, normalize=True, offset=-0.5
                )
                for m in masks
            ]
            vr = misc_ops.valid_ratios(valid_hw, shapes)
        label_query = box_query = attn_mask = None
        if targets is not None:
            if draws is None:
                raise ValueError("the train forward needs the CDN draws")
            dn_m, dn_g = cdn_meta(global_counts(targets), self.denoising_nums)
            label_query, box_query = self.denoising_generator(
                targets.labels, targets.boxes, targets.valid, dn_m, dn_g, draws
            )
            t = self.transformer
            num_matching = min(t.two_stage_num_proposals, sum(h * w for h, w in shapes))
            attn_mask = cdn_attn_mask(
                dn_m, dn_g, self.denoising_generator.num_denoising_queries, num_matching,
                images.device,
            )
        outputs_class, outputs_coord, enc_class, enc_coord, salience, proposals = self.transformer(
            feats, masks, pos_embeds, valid_hw, vr, label_query, box_query, attn_mask
        )
        out = {
            "enc_class": enc_class,
            "enc_coord": enc_coord,
            "salience": salience,
            "proposal_index": proposals,
            "feature_strides": [(canvas[0] / h, canvas[1] / w) for h, w in shapes],
        }
        if targets is None:
            out["pred_class"] = outputs_class
            out["pred_coord"] = outputs_coord
        else:
            ndn = self.denoising_generator.num_denoising_queries
            out["dn_class"] = outputs_class[:, :, :ndn]
            out["dn_coord"] = outputs_coord[:, :, :ndn]
            out["pred_class"] = outputs_class[:, :, ndn:]
            out["pred_coord"] = outputs_coord[:, :, ndn:]
            out["dn_m"], out["dn_groups"] = dn_m, dn_g
        return out


def compute_loss(outputs: Dict[str, Any], targets: Targets, image_sizes: torch.Tensor,
                 criterion: SetCriterion, salience_criterion: SalienceCriterion, num_boxes,
                 weight_dict: Optional[Dict[str, float]] = None,
                 denoising_nums: int = 100) -> Dict[str, torch.Tensor]:
    """Hungarian, denoising and salience losses, each times its weight
    (the JAX package's compute_loss); call outside autocast."""
    if weight_dict is None:
        weight_dict = default_weight_dict(outputs["pred_class"].shape[0])
    losses = criterion(
        outputs["pred_class"], outputs["pred_coord"], outputs["enc_class"],
        outputs["enc_coord"], targets, num_boxes,
    )
    if "dn_class" in outputs:
        m, g = outputs["dn_m"], outputs["dn_groups"]
        query_idx, gt_idx, pair_live = cdn_match_indices(
            m, g, denoising_nums, outputs["dn_class"].device
        )
        losses.update(criterion.dn_loss(
            outputs["dn_class"], outputs["dn_coord"], targets, num_boxes, query_idx, gt_idx,
            pair_live, m, g,
        ))
    losses.update(salience_criterion(
        outputs["salience"], targets, outputs["feature_strides"], image_sizes
    ))
    return {k: v * weight_dict[k] for k, v in losses.items() if k in weight_dict}


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of float [0, 1] RGB images (B, 3, H, W)."""
    mean = misc_ops.device_constant(IMAGENET_MEAN, images.device, images.dtype)
    std = misc_ops.device_constant(IMAGENET_STD, images.device, images.dtype)
    return (images - mean[:, None, None]) / std[:, None, None]
