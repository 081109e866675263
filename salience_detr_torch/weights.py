"""Weights bridge: JAX package variables -> this port's ``state_dict``.

The port names its submodules so that ``state_dict()`` keys are upstream
PyTorch's, which are the source names of the weight converter's rules
(``weight_rules.py``, the port's copy of the JAX package's rules).  Exporting
JAX variables through those rules therefore gives a state dict that
``model.load_state_dict(sd, strict=True)`` accepts, as it will upstream
``.pth`` files.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from salience_detr_torch import weight_rules
from salience_detr_torch.models.factory import SalienceDETRConfig

# buffers of upstream's Swin attention that the JAX package computes and no
# rule maps (torchvision registers them as persistent buffers)
UNMAPPED_BUFFERS = ("attn.relative_position_index", "attn.relative_coords_table")


def converter_rules(cfg: SalienceDETRConfig) -> List[Tuple[str, str, str]]:
    """(torch_name, flax_path, transform) rules of a config; these equal the
    JAX converter's ``salience_detr_rules(backbone, stage_with_dcn)`` with
    the config's layer and level counts."""
    return weight_rules.salience_detr_rules(
        cfg.backbone, tuple(cfg.stage_with_dcn),
        num_encoder_layers=cfg.num_encoder_layers,
        num_decoder_layers=cfg.num_decoder_layers,
        num_levels=cfg.num_feature_levels,
        num_channel_mapper_convs=cfg.num_feature_levels,
    )


def drop_unmapped_buffers(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An upstream state dict without the Swin attention buffers that the
    port computes (``UNMAPPED_BUFFERS``, by name), so that it loads
    strictly."""
    return {k: v for k, v in state.items() if not k.endswith(UNMAPPED_BUFFERS)}


def state_dict_from_jax(variables_numpy: Dict, cfg: SalienceDETRConfig) -> Dict[str, torch.Tensor]:
    """JAX variables ({"params", "frozen", "batch_stats"} of numpy arrays) ->
    a float32 state dict in the upstream layout.  Raises if any rule found no
    variable (for example an eval-only init that lacks the denoising table)."""
    state, skipped = weight_rules.export_torch_state_dict(variables_numpy, converter_rules(cfg))
    if skipped:
        raise ValueError(f"JAX variables lack {len(skipped)} rule targets, e.g. {skipped[:5]}")
    return {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in state.items()
    }


def _load_tolerant(model: torch.nn.Module, updates: Dict[str, torch.Tensor], what: str, logger=None) -> int:
    """Merge ``updates`` into the model's state dict by name and shape (see
    ``utils.checkpoint.tolerant_update``); raises when no tensor applies."""
    from salience_detr_torch.utils.checkpoint import tolerant_update

    merged, applied, mismatches = tolerant_update(model.state_dict(), updates, logger)
    if applied == 0:
        raise ValueError(f"{what} applied 0 tensors (of {len(updates)}; e.g. {mismatches[:3]}): wrong model?")
    model.load_state_dict(merged, strict=True)
    if logger:
        logger.info(f"{what}: applied {applied} tensors, skipped {len(mismatches)}")
    return applied


def load_backbone_weights(model: torch.nn.Module, path: str, logger=None) -> int:
    """An ImageNet ``.pth`` of the backbone (the family's bare upstream names:
    torchvision's ResNet, ConvNeXt, Swin and ViT, the official FocalNet; an
    optional DataParallel ``module.`` prefix) into the detector's backbone
    under its family's wrapper prefix (``backbone.`` for the ResNets and
    ConvNeXt, ``backbone.0.`` for Swin, FocalNet and ViT, whose detector
    wraps the network); returns the number of tensors applied.  Swin's
    attention buffers are dropped by name, and a ViT position table with a
    class-token slot loses it."""
    from salience_detr_torch.utils.checkpoint import load_torch_weights

    prefix = "backbone." + model.backbone.weights_prefix
    state = {}
    for k, v in drop_unmapped_buffers(load_torch_weights(path)).items():
        k = prefix + (k[len("module."):] if k.startswith("module.") else k)
        if k.endswith("encoder.pos_embedding") and int(math.isqrt(v.shape[1] - 1)) ** 2 == v.shape[1] - 1:
            v = v[:, 1:]
        state[k] = v
    return _load_tolerant(model, state, f"pretrained backbone {path}", logger)


def load_finetune_weights(model: torch.nn.Module, source: str, logger=None) -> int:
    """A whole detector's weights for fine-tuning: an upstream ``.pth`` or a
    port checkpoint file, or a checkpoint directory (its newest checkpoint).
    Tensors whose shape differs (a head with another class count) are skipped
    and logged; returns the number applied."""
    from salience_detr_torch.utils.checkpoint import CheckpointManager, load_torch_weights

    if str(source).endswith(".pth"):
        state = drop_unmapped_buffers(load_torch_weights(source))
    else:
        restored = CheckpointManager(source).restore_weights() if os.path.isdir(source) else None
        if restored is None:
            raise ValueError(f"finetune_weights: no checkpoint under {source}")
        state = restored["model"]
    return _load_tolerant(model, state, f"finetune weights {source}", logger)
