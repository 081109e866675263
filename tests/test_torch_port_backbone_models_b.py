"""Tiny detectors with FocalNet, ViT and EVA-02 backbones, and the tiny R50
5-scale model, against the JAX package (the checks and helpers of
tests/test_torch_port_backbone_models.py)."""

import pytest

from tests.test_torch_port_backbone_models import check_detector
from tests.test_torch_port_backbones import tiny_archs  # noqa: F401  (fixture)
from tests.torch_port_common import two_torch_threads  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("fields", [
    dict(backbone="focalnet_tiny_conv"),
    dict(backbone="vit_tiny"),
    dict(backbone="eva_02_tiny"),
    dict(backbone="resnet18", backbone_return_indices=(0, 1, 2, 3), max_num_embedding=40),
], ids=lambda f: "5scale" if "max_num_embedding" in f else f["backbone"])
def test_tiny_detector_slice_parity(tiny_archs, monkeypatch, fields):  # noqa: F811
    check_detector(monkeypatch, fields)
