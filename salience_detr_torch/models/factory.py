"""Model factory (port of salience_detr_tpu/models/factory.py).

``SalienceDETRConfig`` holds the fields the eval and train paths read, with
torch dtypes; ``build_backbone`` dispatches on the backbone name as the JAX
factory does (ResNet, wide ResNet and ResNeXt; ConvNeXt; Swin v1 and v2;
FocalNet; ViT and EVA-02); ``build_salience_detr`` composes the detector,
initializes it from an explicit ``torch.Generator`` with the JAX package's
initializers (so that a random-weight model at full width samples sane
locations), freezes the configured stages of a ResNet backbone (the JAX
freezing predicate names ResNet modules only), and moves it to the given
device in eval mode; ``build_criteria`` makes the matching and salience
criteria.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from salience_detr_torch.models.backbones.convnext import ConvNeXtBackbone
from salience_detr_torch.models.backbones.focalnet import FocalNetBackbone
from salience_detr_torch.models.backbones.resnet import ResNetBackbone, freeze_stages
from salience_detr_torch.models.backbones.swin import SwinTransformerBackbone
from salience_detr_torch.models.backbones.vit import VisionTransformerBackbone
from salience_detr_torch.models.bricks.attention import (
    MultiheadAttention,
    MultiScaleDeformableAttention,
    offset_bias_grid,
)
from salience_detr_torch.models.bricks.criterion import SalienceCriterion, SetCriterion
from salience_detr_torch.models.bricks.deform_conv import DeformConv2dPack
from salience_detr_torch.models.bricks.post_process import PostProcess
from salience_detr_torch.models.bricks.salience_transformer import SalienceTransformer
from salience_detr_torch.models.detectors.salience_detr import SalienceDETR
from salience_detr_torch.models.necks.channel_mapper import ChannelMapper


@dataclass
class SalienceDETRConfig:
    # architecture
    embed_dim: int = 256
    num_classes: int = 91
    num_queries: int = 900
    num_feature_levels: int = 4
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    dim_feedforward: int = 2048
    num_points: int = 4
    topk_sa: int = 300
    level_filter_ratio: Tuple[float, ...] = (0.4, 0.8, 1.0, 1.0)
    layer_filter_ratio: Tuple[float, ...] = (1.0, 0.8, 0.6, 0.6, 0.4, 0.2)
    max_num_embedding: int = 200
    # deformable-attention location groups G (1 <= G <= num_heads, dividing
    # it): 1 = head-shared sampling, None = one group per head (the
    # reference's exact sampling).  The JAX config's shared_sampling_locations
    # / sampling_groups / decoder_sampling_groups map onto these two.
    encoder_sampling_groups: Optional[int] = None
    decoder_sampling_groups: Optional[int] = None
    # backbone: an arch of one of the families' ARCH_SETTINGS
    backbone: str = "resnet50"
    backbone_return_indices: Tuple[int, ...] = (1, 2, 3)
    backbone_freeze_indices: Tuple[int, ...] = (0,)
    # ResNet only: per stage, modulated deformable convs (DCNv2) in conv2 of
    # every block
    stage_with_dcn: Tuple[bool, ...] = (False, False, False, False)
    # contrastive denoising: 2 * denoising_nums CDN slots in training
    denoising_nums: int = 100
    # matcher and losses
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    salience_limit_range: Sequence[Tuple[float, float]] = (
        (-1, 64), (64, 128), (128, 256), (256, 99999),
    )
    # eval geometry: shortest side min_size, longest side at most max_size
    min_size: int = 800
    max_size: int = 1333
    select_box_nums_for_evaluation: int = 300
    # compute dtype on CUDA (autocast; the master weights stay float32); CPU
    # runs float32
    dtype: torch.dtype = torch.float32

    def encoder_groups(self) -> int:
        return self.encoder_sampling_groups or self.num_heads

    def decoder_groups(self) -> int:
        return self.decoder_sampling_groups or self.num_heads


def exact_sampling(cfg: SalienceDETRConfig) -> SalienceDETRConfig:
    """``cfg`` with one location group per head in the encoder and the
    decoder: the per-head sampling-offset layout of upstream checkpoints,
    which the evaluation of such a checkpoint forces (the JAX CLI's
    torch-checkpoint override)."""
    return dataclasses.replace(cfg, encoder_sampling_groups=None, decoder_sampling_groups=None)


def _prior_bias(prior_prob: float = 0.01) -> float:
    return -math.log((1 - prior_prob) / prior_prob)


def build_backbone(cfg: SalienceDETRConfig) -> nn.Module:
    """The backbone of ``cfg.backbone``, dispatched by name as the JAX
    factory does; the ViT's pyramid gives ``embed_dim`` channels."""
    name, idx = cfg.backbone, cfg.backbone_return_indices
    if name.startswith(("resnet", "resnext", "wide_resnet")):
        return ResNetBackbone(name, idx, cfg.stage_with_dcn)
    if name.startswith("conv"):
        return ConvNeXtBackbone(name, idx)
    if name.startswith("swin"):
        return SwinTransformerBackbone(name, idx)
    if name.startswith("focalnet"):
        return FocalNetBackbone(name, idx)
    if name.startswith(("vit", "eva")):
        return VisionTransformerBackbone(name, idx, cfg.embed_dim)
    raise ValueError(f"unknown backbone {name}")


@torch.no_grad()
def init_weights(model: SalienceDETR, generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from ``generator``; a backbone
    other than a ResNet initializes itself (``init_weights``)."""
    g = generator
    own_init = not isinstance(model.backbone, ResNetBackbone)
    dcn_convs = {id(c) for m in model.modules() if isinstance(m, DeformConv2dPack)
                 for c in (m.conv_offset, m.conv_mask)}
    for name, m in model.named_modules():
        if id(m) in dcn_convs or (own_init and name.startswith("backbone.")):
            continue  # a DeformConv2dPack's own convs: with the pack below
        if isinstance(m, DeformConv2dPack):
            # flax: zero offset and mask convs (every tap on its pixel, mask
            # 0.5), kernel variance_scaling(1/3, fan_in, uniform) on (9, Cin,
            # F), which is uniform in +-1/sqrt(9 * Cin)
            for conv in (m.conv_offset, m.conv_mask):
                nn.init.zeros_(conv.weight)
                nn.init.zeros_(conv.bias)
            bound = 1.0 / math.sqrt(m.deform_conv2d.weight[0].numel())
            nn.init.uniform_(m.deform_conv2d.weight, -bound, bound, generator=g)
        elif isinstance(m, nn.Conv2d):
            if name.startswith("backbone."):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=g)
            else:
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=g)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=g)
        elif isinstance(m, nn.Linear):
            nn.init.xavier_uniform_(m.weight, generator=g)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            m.reset_parameters()
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, generator=g)
        elif isinstance(m, MultiheadAttention):
            nn.init.xavier_uniform_(m.in_proj_weight, generator=g)
            nn.init.zeros_(m.in_proj_bias)
    for m in model.modules():
        if isinstance(m, MultiScaleDeformableAttention):
            nn.init.zeros_(m.sampling_offsets.weight)
            grid = offset_bias_grid(m.sampling_groups, m.num_levels, m.num_points)
            m.sampling_offsets.bias.copy_(torch.from_numpy(grid).float())
            nn.init.zeros_(m.attention_weights.weight)
            nn.init.zeros_(m.attention_weights.bias)
    t = model.transformer
    for head in [t.encoder_class_head, *t.decoder.class_head]:
        nn.init.kaiming_uniform_(head.weight, a=math.sqrt(5), generator=g)
        nn.init.constant_(head.bias, _prior_bias())
    for mlp in [t.encoder_bbox_head, *t.decoder.bbox_head]:
        nn.init.zeros_(mlp.layers[-1].weight)
        nn.init.zeros_(mlp.layers[-1].bias)
    nn.init.normal_(t.level_embeds, generator=g)
    nn.init.uniform_(t.alpha, -0.3, 0.3, generator=g)
    bg = t.encoder.background_embedding
    nn.init.uniform_(bg.row_embed.weight, 0.0, 1.0, generator=g)
    nn.init.uniform_(bg.col_embed.weight, 0.0, 1.0, generator=g)
    if own_init:
        model.backbone.init_weights(g)


def build_salience_detr(
    cfg: SalienceDETRConfig,
    device: torch.device,
    generator: Optional[torch.Generator] = None,
):
    """Returns (model, postprocess); the model is in eval mode on ``device``,
    initialized from ``generator`` (seed 0 when None)."""
    backbone = build_backbone(cfg)
    neck = ChannelMapper(backbone.num_channels, cfg.embed_dim, cfg.num_feature_levels)
    transformer = SalienceTransformer(
        num_classes=cfg.num_classes,
        embed_dim=cfg.embed_dim,
        num_encoder_layers=cfg.num_encoder_layers,
        num_decoder_layers=cfg.num_decoder_layers,
        num_heads=cfg.num_heads,
        d_ffn=cfg.dim_feedforward,
        num_feature_levels=cfg.num_feature_levels,
        num_points=cfg.num_points,
        topk_sa=cfg.topk_sa,
        two_stage_num_proposals=cfg.num_queries,
        level_filter_ratio=cfg.level_filter_ratio,
        layer_filter_ratio=cfg.layer_filter_ratio,
        max_num_embedding=cfg.max_num_embedding,
        encoder_sampling_groups=cfg.encoder_groups(),
        decoder_sampling_groups=cfg.decoder_groups(),
    )
    model = SalienceDETR(backbone, neck, transformer, cfg.num_classes, cfg.denoising_nums)
    # the config travels with the model: the optimizer's parameter groups
    # read the converter's rules of it
    model.config = cfg
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    if isinstance(backbone, ResNetBackbone):
        freeze_stages(backbone, cfg.backbone_freeze_indices)
    return model.to(device).eval(), PostProcess(cfg.select_box_nums_for_evaluation)


def build_criteria(cfg: SalienceDETRConfig):
    """(SetCriterion, SalienceCriterion) of the config: hybrid IoU-aware
    matching loss and the salience supervision, as the JAX factory builds."""
    criterion = SetCriterion(
        cfg.num_classes, cfg.cost_class, cfg.cost_bbox, cfg.cost_giou, cfg.focal_alpha,
        cfg.focal_gamma, hybrid=True,
    )
    salience = SalienceCriterion(cfg.salience_limit_range, noise_scale=0.0, alpha=cfg.focal_alpha,
                                 gamma=cfg.focal_gamma)
    return criterion, salience
