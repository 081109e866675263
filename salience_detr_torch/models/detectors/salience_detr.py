"""SalienceDETR detector, eval forward (port of
salience_detr_tpu/models/detectors/salience_detr.py without contrastive
denoising).

Input contract, as in the JAX package with NCHW images:
* images: (B, 3, H, W) float, normalized and padded to the canvas;
* image_sizes: (B, 2) int valid (h, w); every mask derives from it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from salience_detr_torch.models.bricks.salience_transformer import SalienceTransformer
from salience_detr_torch.ops import misc as misc_ops
from salience_detr_torch.ops.pos_encoding import sine_position_embedding

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DenoisingGenerator(nn.Module):
    """Holds the contrastive-denoising label table so that upstream and JAX
    weights load with ``strict=True``; the eval forward does not use it."""

    def __init__(self, num_classes: int, embed_dim: int):
        super().__init__()
        self.label_encoder = nn.Embedding(num_classes, embed_dim)


class SalienceDETR(nn.Module):
    """Backbone + ChannelMapper + SalienceTransformer."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, transformer: SalienceTransformer,
                 num_classes: int = 91):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.transformer = transformer
        self.denoising_generator = DenoisingGenerator(num_classes, transformer.embed_dim)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Dict[str, Any]:
        canvas = tuple(images.shape[-2:])
        feats = self.neck(self.backbone(images))  # [(B, C, h, w)]
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
        outputs_class, outputs_coord, enc_class, enc_coord, salience, proposals = self.transformer(
            feats, masks, pos_embeds, valid_hw, vr
        )
        return {
            "pred_class": outputs_class,
            "pred_coord": outputs_coord,
            "enc_class": enc_class,
            "enc_coord": enc_coord,
            "salience": salience,
            "proposal_index": proposals,
        }


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of float [0, 1] RGB images (B, 3, H, W)."""
    mean = misc_ops.device_constant(IMAGENET_MEAN, images.device, images.dtype)
    std = misc_ops.device_constant(IMAGENET_STD, images.device, images.dtype)
    return (images - mean[:, None, None]) / std[:, None, None]
