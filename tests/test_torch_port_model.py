"""The port's eval slice vs the JAX package, end to end, at the tiny config of
tests/test_full_model_parity.py in the flagship's hybrid sampling mode (G=1
encoder, G=H decoder): the JAX variables go through ``state_dict_from_jax``
into the port with ``strict=True``, both models run the same numpy images,
with one image smaller than the canvas so that padded tokens tie.

Checked: every decoder layer's class logits and boxes, the selected
proposals' class logits and boxes, the salience maps (rtol 1e-3, atol 1e-3:
the full-model tolerance of test_full_model_parity.py), and the grid-NMS
proposal indices exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks import salience_transformer as jax_st
from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.utils.weight_converter import salience_detr_rules
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.weights import converter_rules, state_dict_from_jax
from tests.torch_port_common import (
    CANVAS,
    build_jax_tiny,
    jax_variable_shapes,
    random_variables,
    t,
)

RTOL, ATOL = 1e-3, 1e-3


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg, jmodel = build_jax_tiny()
    variables = random_variables(jax_variable_shapes(jmodel), seed=0)
    tmodel, post = build_salience_detr(tcfg, torch.device("cpu"))
    tmodel.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
    return jcfg, tcfg, jmodel, variables, tmodel


def test_state_dict_keys_are_the_rules_sources(tiny):
    _, tcfg, _, _, tmodel = tiny
    keys = {k for k in tmodel.state_dict() if not k.endswith("num_batches_tracked")}
    assert keys == {src for src, _, _ in converter_rules(tcfg)}


def test_r50_rules_equal_the_converters():
    assert converter_rules(SalienceDETRConfig()) == salience_detr_rules("resnet50")


def test_flagship_weights_load_strict():
    """The flagship's JAX tree (eval_shape, no compute) exports with no
    skipped rule, including the head-shared encoder's Linear(256, 32)
    sampling offsets, and loads strictly into the port's flagship model."""
    cfg = load_config(DEFAULT_CONFIG)
    jcfg = JaxConfig(shared_sampling_locations=True, decoder_sampling_groups=0)
    jmodel, *_ = build_jax(jcfg)
    shapes = jax_variable_shapes(jmodel, canvas=(64, 64))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros, cfg)
    assert tuple(sd["transformer.encoder.layers.0.self_attn.sampling_offsets.weight"].shape) == (32, 256)
    assert tuple(sd["transformer.decoder.layers.0.cross_attn.sampling_offsets.weight"].shape) == (256, 256)
    model, _ = build_salience_detr(cfg, torch.device("cpu"))
    model.load_state_dict(sd, strict=True)


def test_tiny_slice_parity(tiny, monkeypatch):
    jcfg, tcfg, jmodel, variables, tmodel = tiny
    check_slice_parity(jmodel, variables, tmodel, monkeypatch)


def check_slice_parity(jmodel, variables, tmodel, monkeypatch):
    """The eval forward of both models on the same two images (one padded):
    proposal indices exact, salience maps and outputs at RTOL / ATOL."""
    B, (H, W) = 2, CANVAS
    rng = np.random.default_rng(42)
    images = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    sizes = np.asarray([[H, W], [70, 101]], np.int32)

    captured = []
    real_nms = jax_st.grid_nms_topk

    def recording_nms(topk_index, shapes, num_out):
        out = real_nms(topk_index, shapes, num_out)
        jax.debug.callback(lambda v: captured.append(np.asarray(v)), out)
        return out

    monkeypatch.setattr(jax_st, "grid_nms_topk", recording_nms)
    apply = jax.jit(lambda v, x, s: jmodel.apply(v, x, s, train=False))
    want = apply(variables, jnp.asarray(images), jnp.asarray(sizes))
    jax.effects_barrier()

    with torch.no_grad():
        got = tmodel(t(images).permute(0, 3, 1, 2).contiguous(), t(sizes).long())

    # the callbacks of the vmapped NMS arrive in no fixed image order; the
    # per-image pairing is held by enc_class / enc_coord below
    assert len(captured) == B
    np.testing.assert_array_equal(
        np.stack(sorted(map(tuple, got["proposal_index"].numpy()))),
        np.stack(sorted(map(tuple, captured))),
    )
    for lvl, s in enumerate(want["salience"]):
        np.testing.assert_allclose(
            got["salience"][lvl].numpy(), np.asarray(s), rtol=RTOL, atol=ATOL,
            err_msg=f"salience level {lvl}",
        )
    for key in ("enc_class", "enc_coord", "pred_class", "pred_coord"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL, err_msg=key
        )
