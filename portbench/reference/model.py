"""Builds the reference detector from a configuration's ``model`` fields
(the JSON beside each configuration) and holds the numerics it runs in."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.channel_mapper import ChannelMapper
from portbench.reference.criterion import SalienceCriterion, SetCriterion
from portbench.reference.detector import SalienceDETR
from portbench.reference.post_process import PostProcess
from portbench.reference.resnet import ResNetBackbone, freeze_stages
from portbench.reference.transformer import SalienceTransformer


def exact_float32() -> None:
    """float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def build(m: Dict, device="cpu") -> SalienceDETR:
    """The detector of the fields ``m`` on ``device``, parameters
    uninitialised (a state dict fills them), frozen stages without gradients."""
    if not str(m["backbone"]).startswith("resnet"):
        raise NotImplementedError(f"the reference builds ResNet backbones only, not {m['backbone']}")
    heads = m["num_heads"]
    with torch.device("meta"):
        backbone = ResNetBackbone(m["backbone"], tuple(m["backbone_return_indices"]))
        neck = ChannelMapper(backbone.num_channels, m["embed_dim"], m["num_feature_levels"])
        transformer = SalienceTransformer(
            num_classes=m["num_classes"], embed_dim=m["embed_dim"],
            num_encoder_layers=m["num_encoder_layers"], num_decoder_layers=m["num_decoder_layers"],
            num_heads=heads, d_ffn=m["dim_feedforward"], num_feature_levels=m["num_feature_levels"],
            num_points=m["num_points"], topk_sa=m["topk_sa"], two_stage_num_proposals=m["num_queries"],
            level_filter_ratio=tuple(m["level_filter_ratio"]), layer_filter_ratio=tuple(m["layer_filter_ratio"]),
            max_num_embedding=m["max_num_embedding"],
            encoder_sampling_groups=m["encoder_sampling_groups"] or heads,
            decoder_sampling_groups=m["decoder_sampling_groups"] or heads,
        )
        model = SalienceDETR(backbone, neck, transformer, m["num_classes"], m["denoising_nums"])
    model = model.to_empty(device=device)
    freeze_stages(model.backbone, tuple(m["backbone_freeze_indices"]))
    return model.eval()


def postprocess(m: Dict) -> PostProcess:
    return PostProcess(m["select_box_nums_for_evaluation"])


def criteria(m: Dict):
    criterion = SetCriterion(m["num_classes"], m["cost_class"], m["cost_bbox"], m["cost_giou"],
                             m["focal_alpha"], m["focal_gamma"], hybrid=True)
    salience = SalienceCriterion([tuple(r) for r in m["salience_limit_range"]], noise_scale=0.0,
                                 alpha=m["focal_alpha"], gamma=m["focal_gamma"])
    return criterion, salience


def checkpointed(model: SalienceDETR) -> SalienceDETR:
    """Recompute in the backward the activations of each backbone stage,
    encoder and decoder layer and of the neck, so that a float32 step fits
    where the program's bfloat16 step does.  The same arithmetic; a choice
    made again in the recomputation is the same choice under the same site."""
    from torch.utils.checkpoint import checkpoint

    names = [f"backbone.layer{i}" for i in range(1, 5)] + ["transformer.neck"]
    names += [f"transformer.encoder.layers.{i}" for i in range(len(model.transformer.encoder.layers))]
    names += [f"transformer.decoder.layers.{i}" for i in range(len(model.transformer.decoder.layers))]
    for name in names:
        module = model.get_submodule(name)
        forward = module.forward
        module.forward = lambda *a, _f=forward, **k: checkpoint(_f, *a, use_reentrant=False, **k)
    return model
