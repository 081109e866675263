"""Weights bridge: JAX package variables -> this port's ``state_dict``.

The port names its submodules so that ``state_dict()`` keys are upstream
PyTorch's, which are the source names of the JAX package's weight-converter
rules (salience_detr_tpu/utils/weight_converter.py).  Exporting JAX
variables through those rules therefore gives a state dict that
``model.load_state_dict(sd, strict=True)`` accepts, as it will upstream
``.pth`` files.

The converter module is numpy-only, but importing it through its package
would run ``salience_detr_tpu/__init__.py``, which imports JAX; it is loaded
from its file instead, so the port stays free of JAX.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from salience_detr_torch.models.backbones.resnet import ARCH_SETTINGS
from salience_detr_torch.models.factory import SalienceDETRConfig

_CONVERTER_PATH = (
    Path(__file__).resolve().parent.parent / "salience_detr_tpu" / "utils" / "weight_converter.py"
)
_converter = None


def weight_converter():
    """salience_detr_tpu/utils/weight_converter.py, loaded from its file."""
    global _converter
    if _converter is None:
        spec = importlib.util.spec_from_file_location(
            "salience_detr_torch._weight_converter", _CONVERTER_PATH
        )
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _converter = module
    return _converter


def converter_rules(cfg: SalienceDETRConfig) -> List[Tuple[str, str, str]]:
    """(torch_name, flax_path, transform) rules for a ResNet-backbone config;
    for resnet50 these equal the converter's ``salience_detr_rules("resnet50")``."""
    wc = weight_converter()
    arch = ARCH_SETTINGS[cfg.backbone]
    return wc._resnet_rules(arch["layers"], arch["block"] == "bottleneck") + wc.salience_detr_head_rules(
        num_encoder_layers=cfg.num_encoder_layers,
        num_decoder_layers=cfg.num_decoder_layers,
        num_levels=cfg.num_feature_levels,
        num_channel_mapper_convs=cfg.num_feature_levels,
    )


def state_dict_from_jax(variables_numpy: Dict, cfg: SalienceDETRConfig) -> Dict[str, torch.Tensor]:
    """JAX variables ({"params", "frozen", "batch_stats"} of numpy arrays) ->
    a float32 state dict in the upstream layout.  Raises if any rule found no
    variable (for example an eval-only init that lacks the denoising table)."""
    state, skipped = weight_converter().export_torch_state_dict(variables_numpy, converter_rules(cfg))
    if skipped:
        raise ValueError(f"JAX variables lack {len(skipped)} rule targets, e.g. {skipped[:5]}")
    return {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in state.items()
    }
