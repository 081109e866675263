"""The port's DCNv2 (modulated deformable convolution, ``stage_with_dcn``)
against the JAX package, on the CPU (plain versions), float32, inputs from
numpy seeds with offsets off the integer pixel grid and taps outside the
image.

Checked: the sampling (``deform_conv_sample_plain``) against the JAX
``_bilinear_sample_map`` times the mask (rtol 1e-5, atol 1e-6: the same f32
operations, possibly contracted into fused multiply-adds by XLA), and its
plain backward against ``jax.vjp`` and against autograd of the plain forward
(max |d| <= 1e-5 max |g| + 1e-6 per gradient: sums in another order);
``DeformConv2dPack`` at strides 1 and 2, forward (rtol 1e-3, atol 1e-5) and
vector-Jacobian product (max |d| <= 1e-4 max |g|); an R50-DCN backbone
(stages 2-4 deformable) at 64x64 (rtol 1e-3, atol 1e-4 of each map's
largest value); the converter's DCN rules and a strict load of the R50-DCN
config; and the tiny model with DCN stages: its eval forward (rtol 1e-3,
atol 1e-3, proposal indices exact) and one train step through
``jax.value_and_grad`` (the checks of tests/test_torch_port_train.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.backbones.resnet import ResNetBackbone as JaxResNet
from salience_detr_tpu.models.bricks.deform_conv import DeformConv2dPack as JaxDCN
from salience_detr_tpu.models.bricks.deform_conv import _bilinear_sample_map
from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.utils import weight_converter as jax_wc
from salience_detr_torch import weight_rules
from salience_detr_torch.inference import load_config
from salience_detr_torch.models.backbones.resnet import ResNetBackbone
from salience_detr_torch.models.bricks.deform_conv import DeformConv2dPack
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.ops.deform_conv import (
    deform_conv_sample,
    deform_conv_sample_backward_plain,
    deform_conv_sample_plain,
    output_size,
)
from salience_detr_torch.weights import converter_rules, state_dict_from_jax
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
    export_subtree,
    jax_variable_shapes,
    random_variables,
    t,
)

DCN = (False, True, True, True)
DCN_CONFIG = "configs/salience_detr_torch/salience_detr_resnet50_dcn_800_1333.py"


def jax_sample(x, offsets, mask, stride):
    """The JAX module's sampling (deform_conv.py:74-95) on given offsets and
    mask: (B, Ho, Wo, 9, C) float32."""
    B, H, W, C = x.shape
    Ho, Wo = offsets.shape[1:3]
    gy, gx = jnp.meshgrid(jnp.arange(Ho, dtype=jnp.float32) * stride,
                          jnp.arange(Wo, dtype=jnp.float32) * stride, indexing="ij")
    ky, kx = jnp.meshgrid(jnp.arange(3, dtype=jnp.float32) - 1, jnp.arange(3, dtype=jnp.float32) - 1,
                          indexing="ij")
    py = gy[None, :, :, None] + ky.reshape(-1)[None, None, None, :] + offsets[..., 0::2]
    px = gx[None, :, :, None] + kx.reshape(-1)[None, None, None, :] + offsets[..., 1::2]
    sampled = _bilinear_sample_map(x, px.reshape(B, -1), py.reshape(B, -1)).reshape(B, Ho, Wo, 9, C)
    return sampled * mask[..., None]


def sample_inputs(stride, seed, B=2, H=9, W=11, C=6):
    """x normal; offsets normal with std 2 pixels (taps off the grid, some
    outside the image); mask uniform in (0, 1)."""
    rng = np.random.default_rng(seed)
    Ho, Wo = output_size(H, stride), output_size(W, stride)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    offsets = (2.0 * rng.normal(size=(B, Ho, Wo, 18))).astype(np.float32)
    mask = rng.uniform(0.05, 0.95, size=(B, Ho, Wo, 9)).astype(np.float32)
    return x, offsets, mask


def assert_grad_close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= bound, (name, np.abs(got - want).max(), bound)


@pytest.mark.parametrize("stride", [1, 2])
def test_sample_and_its_backward_match_jax(stride):
    x, offsets, mask = sample_inputs(stride, seed=stride)
    want, vjp = jax.vjp(lambda *a: jax_sample(*a, stride), *map(jnp.asarray, (x, offsets, mask)))
    got = deform_conv_sample_plain(t(x), t(offsets), t(mask), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # at least a tenth of the taps have a corner outside the image
    py = np.arange(output_size(x.shape[1], stride))[None, :, None, None] * stride + offsets[..., 0::2]
    assert ((py < 0) | (py > x.shape[1] - 1)).mean() > 0.1

    d_cols = np.random.default_rng(9).normal(size=got.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(d_cols))
    plain = deform_conv_sample_backward_plain(t(x), t(offsets), t(mask), stride, t(d_cols))
    inputs = [t(a).requires_grad_() for a in (x, offsets, mask)]
    deform_conv_sample(*inputs, stride).backward(t(d_cols))
    for name, jg, pg, ag in zip(("d_x", "d_offsets", "d_mask"), jgrads, plain, inputs):
        assert_grad_close(pg.numpy(), jg, 1e-5, f"{name} plain vs jax")
        assert_grad_close(ag.grad.numpy(), jg, 1e-5, f"{name} autograd vs jax")
    # without a gradient for x the backward skips the scatter
    _, d_off, d_mask = deform_conv_sample_backward_plain(t(x), t(offsets), t(mask), stride, t(d_cols),
                                                         need_x=False)
    assert torch.equal(d_off, plain[1]) and torch.equal(d_mask, plain[2])


def dcn_variables(jmodule, x, seed):
    """Random module variables: offset convs wide enough to move the taps a
    few pixels, mask convs around 0, the kernel ~ N(0, 1 / (9 Cin))."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), x))["params"]
    rng = np.random.default_rng(seed)
    cin = x.shape[-1]
    params = {
        "conv_offset": {"kernel": rng.normal(size=shapes["conv_offset"]["kernel"].shape) * 0.5,
                        "bias": rng.normal(size=(18,))},
        "conv_mask": {"kernel": rng.normal(size=shapes["conv_mask"]["kernel"].shape) * 0.3,
                      "bias": rng.normal(size=(9,)) * 0.5},
        "kernel": rng.normal(size=shapes["kernel"].shape) / np.sqrt(9 * cin),
    }
    return jax.tree.map(lambda a: np.asarray(a, np.float32), {"params": params})


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_pack_matches_jax(stride):
    rng = np.random.default_rng(20 + stride)
    B, H, W, cin, features = 2, 10, 13, 8, 12
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    jmod = JaxDCN(features, stride=stride, use_bias=False)
    variables = dcn_variables(jmod, jnp.asarray(x), seed=stride)
    want, vjp = jax.vjp(lambda v, a: jmod.apply(v, a), variables, jnp.asarray(x))

    rules = jax_wc._dcn_pack("m", "m")
    sd = export_subtree({"params": {"m": variables["params"]}}, rules, "m.")
    module = DeformConv2dPack(cin, features, stride)
    module.load_state_dict(sd, strict=True)
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    got = module(xt)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)

    cot = rng.normal(size=np.asarray(want).shape).astype(np.float32)
    jgrad_vars, jgrad_x = vjp(jnp.asarray(cot))
    got.backward(t(cot).permute(0, 3, 1, 2))
    assert_grad_close(xt.grad.permute(0, 2, 3, 1).numpy(), jgrad_x, 1e-4, "d_x")
    want_grads = export_subtree({"params": {"m": jgrad_vars["params"]}}, rules, "m.")
    for name, p in module.named_parameters():
        assert_grad_close(p.grad.numpy(), want_grads[name].numpy(), 1e-4, name)


def test_deform_conv_pack_is_a_half_conv_at_init():
    """The port's init (offset and mask convs zero): every tap on its pixel
    with mask 0.5, so the layer is half a plain 3x3 convolution."""
    cfg = SalienceDETRConfig(**TINY_TORCH, stage_with_dcn=DCN)
    model, _ = build_salience_detr(cfg, torch.device("cpu"))
    module = model.backbone.layer3[0].conv2
    assert isinstance(module, DeformConv2dPack)
    assert not module.conv_offset.weight.any() and not module.conv_mask.bias.any()
    w = module.deform_conv2d.weight.detach()
    assert float(w.abs().max()) <= 1 / np.sqrt(w[0].numel()) and float(w.std()) > 0.5 / np.sqrt(3 * w[0].numel())
    x = torch.randn(1, w.shape[1], 7, 9, generator=torch.Generator().manual_seed(0))
    want = 0.5 * torch.nn.functional.conv2d(x, w, padding=1)
    torch.testing.assert_close(module(x), want, rtol=1e-5, atol=1e-5)


def test_init_draws_only_from_the_generator():
    """Two builds from one seed are equal whatever the global RNG did (the
    DCN packs' and the neck's ``conv_mask`` convs included)."""
    cfg = SalienceDETRConfig(**TINY_TORCH, stage_with_dcn=DCN)
    a, _ = build_salience_detr(cfg, torch.device("cpu"), torch.Generator().manual_seed(3))
    torch.manual_seed(123)
    b, _ = build_salience_detr(cfg, torch.device("cpu"), torch.Generator().manual_seed(3))
    want = b.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in a.state_dict().items())


def test_r50_dcn_backbone_matches_jax():
    jmod = JaxResNet(arch="resnet50", stage_with_dcn=DCN)
    x = np.random.default_rng(3).normal(size=(1, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = random_variables(shapes, seed=4)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))

    rules = weight_rules._resnet_rules((3, 4, 6, 3), True, DCN)
    nested = {col: {"backbone": tree} for col, tree in variables.items()}
    backbone = ResNetBackbone("resnet50", (1, 2, 3), DCN)
    backbone.load_state_dict(export_subtree(nested, rules, "backbone."), strict=True)
    assert sum(isinstance(m, DeformConv2dPack) for m in backbone.modules()) == 13
    with torch.no_grad():
        got = backbone(t(x).permute(0, 3, 1, 2).contiguous())
    for stage in (1, 2, 3):
        ref = np.asarray(want[stage])
        np.testing.assert_allclose(got[stage].permute(0, 2, 3, 1).numpy(), ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=f"stage {stage}")


@pytest.mark.parametrize("layers,bottleneck,dcn", [
    ((3, 4, 6, 3), True, DCN), ((2, 2, 2, 2), False, DCN), ((3, 4, 23, 3), True, (False, False, True, True)),
])
def test_dcn_rules_equal_the_jax_converters(layers, bottleneck, dcn):
    assert weight_rules._resnet_rules(layers, bottleneck, dcn) == jax_wc._resnet_rules(layers, bottleneck, dcn)
    assert weight_rules._dcn_pack("a.b", "a/b") == jax_wc._dcn_pack("a.b", "a/b")
    w = np.random.default_rng(1).normal(size=(9, 6, 8)).astype(np.float32)
    np.testing.assert_array_equal(weight_rules._invert_transform(w, "dcn_kernel"),
                                  jax_wc._invert_transform(w, "dcn_kernel"))
    np.testing.assert_array_equal(jax_wc._apply_transform(weight_rules._invert_transform(w, "dcn_kernel"),
                                                          "dcn_kernel"), w)


def test_r50_dcn_config_loads_strict():
    """The R50-DCN config file: the flagship with stage_with_dcn; its rules
    equal the JAX converter's, and the JAX flagship-DCN tree (eval_shape, no
    compute) exports without a skipped rule and loads strictly."""
    cfg = load_config(DCN_CONFIG)
    assert cfg.stage_with_dcn == DCN
    assert dataclasses.replace(cfg, stage_with_dcn=(False,) * 4) == load_config(
        "configs/salience_detr_torch/salience_detr_resnet50_800_1333.py")
    rules = converter_rules(cfg)
    assert rules == jax_wc.salience_detr_rules("resnet50", DCN)
    jmodel, *_ = build_jax(JaxConfig(shared_sampling_locations=True, decoder_sampling_groups=0,
                                     stage_with_dcn=DCN))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jax_variable_shapes(jmodel, canvas=(64, 64)))
    sd = state_dict_from_jax(zeros, cfg)
    assert tuple(sd["backbone.layer2.0.conv2.deform_conv2d.weight"].shape) == (128, 128, 3, 3)
    assert tuple(sd["backbone.layer4.2.conv2.conv_offset.weight"].shape) == (18, 512, 3, 3)
    model, _ = build_salience_detr(cfg, torch.device("cpu"))
    model.load_state_dict(sd, strict=True)
    keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert keys == {src for src, _, _ in rules}


def tiny_dcn():
    jcfg = JaxConfig(**TINY_JAX, stage_with_dcn=DCN)
    tcfg = SalienceDETRConfig(**TINY_TORCH, stage_with_dcn=DCN)
    jmodel, jcrit, jsal, _ = build_jax(jcfg)
    return jcfg, tcfg, jmodel, jcrit, jsal, random_variables(jax_variable_shapes(jmodel), seed=5)


def test_tiny_dcn_slice_parity(monkeypatch):
    jcfg, tcfg, jmodel, _, _, variables = tiny_dcn()
    tmodel, _ = build_salience_detr(tcfg, torch.device("cpu"))
    tmodel.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
    check_slice_parity(jmodel, variables, tmodel, monkeypatch)


def test_tiny_dcn_train_step():
    r = run_tiny_train_step(*tiny_dcn())
    check_step_losses(r)
    check_step_assignments(r)
    assert check_step_gradients(r) > 300
    grads = {n: p.grad for n, p in r["model"].named_parameters() if ".conv_offset." in n}
    assert len(grads) == 2 * 6 and all(float(g.abs().max()) > 0 for g in grads.values())
