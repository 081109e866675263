"""Weights bridge: JAX package variables -> this port's ``state_dict``.

The port names its submodules so that ``state_dict()`` keys are upstream
PyTorch's, which are the source names of the weight converter's rules
(``weight_rules.py``, the port's copy of the JAX package's rules).  Exporting
JAX variables through those rules therefore gives a state dict that
``model.load_state_dict(sd, strict=True)`` accepts, as it will upstream
``.pth`` files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from salience_detr_torch import weight_rules
from salience_detr_torch.models.backbones.resnet import ARCH_SETTINGS
from salience_detr_torch.models.factory import SalienceDETRConfig


def converter_rules(cfg: SalienceDETRConfig) -> List[Tuple[str, str, str]]:
    """(torch_name, flax_path, transform) rules for a ResNet-backbone config;
    these equal the JAX converter's ``salience_detr_rules(backbone,
    stage_with_dcn)``."""
    arch = ARCH_SETTINGS[cfg.backbone]
    return weight_rules._resnet_rules(
        arch["layers"], arch["block"] == "bottleneck", tuple(cfg.stage_with_dcn)
    ) + weight_rules.salience_detr_head_rules(
        num_encoder_layers=cfg.num_encoder_layers,
        num_decoder_layers=cfg.num_decoder_layers,
        num_levels=cfg.num_feature_levels,
        num_channel_mapper_convs=cfg.num_feature_levels,
    )


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
    """An ImageNet ``.pth`` of the backbone (torchvision's bare names, an
    optional DataParallel ``module.`` prefix) into ``backbone.*``; returns
    the number of tensors applied."""
    from salience_detr_torch.utils.checkpoint import load_torch_weights

    state = {
        "backbone." + (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in load_torch_weights(path).items()
    }
    return _load_tolerant(model, state, f"pretrained backbone {path}", logger)


def load_finetune_weights(model: torch.nn.Module, source: str, logger=None) -> int:
    """A whole detector's weights for fine-tuning: an upstream ``.pth`` or a
    port checkpoint file, or a checkpoint directory (its newest checkpoint).
    Tensors whose shape differs (a head with another class count) are skipped
    and logged; returns the number applied."""
    from salience_detr_torch.utils.checkpoint import CheckpointManager, load_torch_weights

    if str(source).endswith(".pth"):
        state = load_torch_weights(source)
    else:
        restored = CheckpointManager(source).restore_weights() if os.path.isdir(source) else None
        if restored is None:
            raise ValueError(f"finetune_weights: no checkpoint under {source}")
        state = restored["model"]
    return _load_tolerant(model, state, f"finetune weights {source}", logger)
