"""The full Swin-L, ConvNeXt-L, FocalNet-L and R50 5-scale configs and the
flagship with an EVA-02-B backbone: the port's config files copy the JAX
configs' fields, and each detector, built on the ``meta`` device (the JAX
model by ``jax.eval_shape``, which computes nothing), has the converter
rules' sources as its state-dict keys, each with the shape of the exported
JAX variable, and loads a JAX export strictly."""

import dataclasses
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.utils import weight_converter as jax_wc
from salience_detr_torch.inference import load_config
from salience_detr_torch.models.factory import build_salience_detr
from salience_detr_torch.weights import converter_rules, state_dict_from_jax
from tests.torch_port_common import jax_variable_shapes, two_torch_threads  # noqa: F401  (autouse fixture)


FULL_CONFIGS = {
    "swin_l": ("configs/salience_detr_torch/salience_detr_swin_l_800_1333.py",
               "configs/salience_detr/salience_detr_swin_l_800_1333.py"),
    "convnext_l": ("configs/salience_detr_torch/salience_detr_convnext_l_800_1333.py",
                   "configs/salience_detr/salience_detr_convnext_l_800_1333.py"),
    "focalnet_l": ("configs/salience_detr_torch/salience_detr_focalnet_large_lrf_800_1333.py",
                   "configs/salience_detr/salience_detr_focalnet_large_lrf_800_1333.py"),
    "r50_5scale": ("configs/salience_detr_torch/salience_detr_resnet50_5scale_800_1333.py",
                   "configs/salience_detr/salience_detr_resnet50_5scale_800_1333.py"),
    "eva02_b": ("configs/salience_detr_torch/salience_detr_resnet50_800_1333.py", None),
}


def full_configs(which):
    """(port config, JAX config) of a full model: a shipped config and its JAX
    twin, or the flagship with the EVA-02-B backbone (no shipped config)."""
    port_path, jax_path = FULL_CONFIGS[which]
    if jax_path is None:
        cfg = dataclasses.replace(load_config(port_path), backbone="eva_02_vit_b_4attn_1024")
        jcfg = JaxConfig(shared_sampling_locations=True, decoder_sampling_groups=0,
                         backbone="eva_02_vit_b_4attn_1024")
        return cfg, jcfg
    spec = importlib.util.spec_from_file_location("jax_cfg", jax_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return load_config(port_path), mod.model_config


def test_configs_copy_the_jax_configs():
    """Every field the two config classes share holds the JAX config's value;
    the sampling fields, which the two classes spell differently, are the
    JAX defaults: exact per-head sampling in the encoder and the decoder."""
    for which in ("swin_l", "convnext_l", "focalnet_l", "r50_5scale"):
        cfg, jcfg = full_configs(which)
        shared = {f.name for f in dataclasses.fields(cfg)} & {f.name for f in dataclasses.fields(jcfg)}
        for name in shared - {"dtype", "decoder_sampling_groups"}:
            assert tuple(np.ravel(getattr(cfg, name))) == tuple(np.ravel(getattr(jcfg, name))), (which, name)
        assert cfg.encoder_sampling_groups is None and cfg.decoder_sampling_groups is None
        assert not jcfg.shared_sampling_locations and jcfg.sampling_groups == 0
        assert jcfg.decoder_sampling_groups == -1
        assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16


@pytest.mark.parametrize("which", list(FULL_CONFIGS))
def test_full_model_state_dict_and_strict_load(which):
    """The full detector on the meta device: its state-dict keys are the
    rules' sources, each with the shape of the JAX variable's export, and a
    JAX export (zeros of the eval_shape tree) loads strictly."""
    cfg, jcfg = full_configs(which)
    rules = converter_rules(cfg)
    assert rules == jax_wc.salience_detr_rules(
        jcfg.backbone, jcfg.stage_with_dcn, num_levels=jcfg.num_feature_levels,
        num_channel_mapper_convs=jcfg.num_feature_levels)
    jmodel, *_ = build_jax(jcfg)
    shapes = jax_variable_shapes(jmodel, canvas=(64, 64))
    sd = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), cfg)
    with torch.device("meta"):
        model, _ = build_salience_detr(cfg, torch.device("meta"))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    assert set(got) == {src for src, _, _ in rules}
    model.load_state_dict(sd, strict=True, assign=True)


