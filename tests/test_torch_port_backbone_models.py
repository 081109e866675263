"""Tiny whole detectors with each backbone family, the port against the JAX
package on the CPU in float32, in the shipped L configs' sampling mode
(exact per-head sampling in the encoder and the decoder).

Checked: the eval forward of a tiny detector per family (ResNeXt, ConvNeXt,
Swin v1, Swin v2, FocalNet, ViT, EVA-02) and of the tiny R50 5-scale model
(return indices (0, 1, 2, 3), four levels at strides 4-32): class logits,
boxes and salience maps at rtol 1e-3 / atol 1e-3, the grid-NMS proposal
indices exact (``check_slice_parity``); and one train step of the tiny Swin
and ConvNeXt detectors (stochastic depth 0) against ``jax.value_and_grad``
of the JAX loss: losses, the Hungarian assignments of every layer exactly,
and every trainable parameter's gradient (the checks of
tests/test_torch_port_train.py).  This file holds the helpers and the first
four families; test_torch_port_backbone_models_b.py and
test_torch_port_backbone_train_{swin,convnext}.py the rest."""

import dataclasses

import pytest
import torch

from salience_detr_tpu.models.backbones import vit as jax_vit
from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.weights import state_dict_from_jax
from tests.test_torch_port_backbones import tiny_archs  # noqa: F401  (fixture)
from tests.test_torch_port_model import check_slice_parity
from tests.test_torch_port_train import (
    check_step_assignments,
    check_step_gradients,
    check_step_losses,
    run_tiny_train_step,
)
from tests.torch_port_common import (
    TINY_JAX,
    TINY_TORCH,
    jax_variable_shapes,
    random_variables,
    two_torch_threads,  # noqa: F401  (autouse fixture)
)

# the tiny model in exact sampling mode: the JAX defaults, no location groups
EXACT_JAX = dict(TINY_JAX, shared_sampling_locations=False, decoder_sampling_groups=-1)
EXACT_TORCH = dict(TINY_TORCH, encoder_sampling_groups=None)


def tiny_detector(seed, **fields):
    jcfg = JaxConfig(**dict(EXACT_JAX, **fields))
    tcfg = SalienceDETRConfig(**dict(EXACT_TORCH, **fields))
    jmodel, jcrit, jsal, _ = build_jax(jcfg)
    variables = random_variables(jax_variable_shapes(jmodel), seed=seed)
    jax_vit.rope_tables.cache_clear()  # it caches arrays; eval_shape left tracers there
    variables.setdefault("frozen", {})  # only a ResNet has FrozenBatchNorm statistics
    return jcfg, tcfg, jmodel, jcrit, jsal, variables


def check_detector(monkeypatch, fields):
    _, tcfg, jmodel, _, _, variables = tiny_detector(3, **fields)
    tmodel, _ = build_salience_detr(tcfg, torch.device("cpu"))
    tmodel.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
    assert tcfg.num_feature_levels == 4
    check_slice_parity(jmodel, variables, tmodel, monkeypatch)


def check_train_step(backbone):
    r = run_tiny_train_step(*tiny_detector(4, backbone=backbone))
    check_step_losses(r)
    check_step_assignments(r)
    backbone_grads = [n for n, p in r["model"].named_parameters()
                      if n.startswith("backbone.") and p.grad is not None and float(p.grad.abs().max()) > 0]
    assert check_step_gradients(r) > 300 and len(backbone_grads) > 50


# the other families' detectors are in test_torch_port_backbone_models_b.py
# and the train steps in test_torch_port_backbone_train_*.py: the lane runs
# whole files on its workers, so each file is kept near a minute and a half
@pytest.mark.parametrize("backbone", ["resnext_tiny", "conv_tiny", "swin_tiny", "swin_v2_tiny"])
def test_tiny_detector_slice_parity(tiny_archs, monkeypatch, backbone):  # noqa: F811
    check_detector(monkeypatch, dict(backbone=backbone))


def test_five_scale_levels():
    """The 5-scale R50: strides 4, 8, 16 and 32 from the backbone, no extra
    neck level; at the 800 x 1344 canvas S = 89,250 tokens."""
    cfg = dataclasses.replace(SalienceDETRConfig(**EXACT_TORCH), backbone="resnet50",
                              backbone_return_indices=(0, 1, 2, 3))
    model, _ = build_salience_detr(cfg, torch.device("meta"))
    assert model.backbone.num_channels == [256, 512, 1024, 2048]
    assert len(model.neck.convs) == 4
    shapes = [(800 // s, 1344 // s) for s in (4, 8, 16, 32)]
    assert sum(h * w for h, w in shapes) == 89250
