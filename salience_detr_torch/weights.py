"""Weights bridge: JAX package variables -> this port's ``state_dict``.

The port names its submodules so that ``state_dict()`` keys are upstream
PyTorch's, which are the source names of the weight converter's rules
(``weight_rules.py``, the port's copy of the JAX package's rules).  Exporting
JAX variables through those rules therefore gives a state dict that
``model.load_state_dict(sd, strict=True)`` accepts, as it will upstream
``.pth`` files.
"""

from __future__ import annotations

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
