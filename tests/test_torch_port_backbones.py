"""The port's backbone families against the JAX package's, on the CPU in
float32: ResNeXt and wide ResNet, ConvNeXt, Swin v1 (shifted windows and
padding) and v2, FocalNet (with and without conv_embed / postln /
normalize_modulator, and with the modulation LayerNorm), ViT and EVA-02 with
the feature pyramid.

Tiny archs go into both packages' ``ARCH_SETTINGS`` through
``monkeypatch.setitem`` (no file of the JAX package changes).  Each backbone
test exports numpy-seeded JAX variables through the converter's rules, loads
them strictly into the port's module and compares every returned map at
rtol 1e-3 / atol 1e-5.  Also checked: the port's rules equal the JAX
converter's for every arch of the four tables (the full detectors' state
dicts are in test_torch_port_backbone_full.py); the parameter groups equal the JAX classifier's on each family;
``DropPath``'s semantics and each family's schedule; bare ImageNet-layout
files load every tensor; and the shapes past the grid-NMS kernel's shared
memory (C-18) in the plain version against the JAX function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.engine import optim as jax_optim
from salience_detr_tpu.models.backbones import convnext as jax_convnext
from salience_detr_tpu.models.backbones import focalnet as jax_focalnet
from salience_detr_tpu.models.backbones import resnet as jax_resnet
from salience_detr_tpu.models.backbones import swin as jax_swin
from salience_detr_tpu.models.backbones import vit as jax_vit
from salience_detr_tpu.ops import nms as jax_nms
from salience_detr_tpu.utils import weight_converter as jax_wc
from salience_detr_torch import weight_rules
from salience_detr_torch.engine.optim import PARAM_GROUPINGS, named_param_groups
from salience_detr_torch.models.backbones import convnext, focalnet, resnet, swin, vit
from salience_detr_torch.models.factory import SalienceDETRConfig, build_backbone, build_salience_detr
from salience_detr_torch.models.layers import DropPath, linear_drop_rates, set_drop_path_generator
from salience_detr_torch.ops.nms import (
    grid_nms_rank_in_global,
    grid_nms_topk,
    grid_nms_topk_plain,
    nms_keep_mask,
    nms_keep_mask_plain,
    nms_keep_plan,
)
from salience_detr_torch.weights import converter_rules, load_backbone_weights
from tests.torch_port_common import (
    TINY_TORCH,
    export_subtree,
    random_variables,
    t,
    two_torch_threads,  # noqa: F401  (autouse fixture)
)

RTOL, ATOL = 1e-3, 1e-5

# tiny archs, one table per family, registered in both packages
TINY_ARCHS = {
    "resnet": {
        "resnext_tiny": dict(block="bottleneck", layers=(1, 1, 1, 1), width=4, groups=8),
        "wide_resnet_tiny": dict(block="bottleneck", layers=(1, 1, 1, 1), width=128),
    },
    "convnext": {"conv_tiny": dict(depths=(1, 1, 2, 1), dims=(16, 32, 48, 64), sd=0.0)},
    "swin": {
        "swin_tiny": dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window=3, sd=0.0),
        "swin_v2_tiny": dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window=3, sd=0.0,
                             v2=True),
    },
    "focalnet": {
        "focalnet_tiny_plain": dict(embed_dim=16, depths=(1, 1, 2, 1), focal_levels=(2,) * 4,
                                    focal_windows=(3,) * 4, conv_embed=False, postln=False,
                                    layerscale=False, norm_mod=False, sd=0.0),
        "focalnet_tiny_conv": dict(embed_dim=16, depths=(1, 1, 2, 1), focal_levels=(3,) * 4,
                                   focal_windows=(3,) * 4, conv_embed=True, postln=True,
                                   layerscale=True, norm_mod=True, sd=0.0),
        "focalnet_tiny_ln": dict(embed_dim=16, depths=(1, 1, 2, 1), focal_levels=(2,) * 4,
                                 focal_windows=(3,) * 4, conv_embed=True, postln=True,
                                 layerscale=True, norm_mod=False, postln_in_mod=True, sd=0.0),
    },
    "vit": {
        "vit_tiny": dict(embed_dim=32, depth=3, num_heads=2, window=4, global_idx=(1,), pos_grid=14),
        "eva_02_tiny": dict(embed_dim=32, depth=3, num_heads=2, mlp_dim=48, window=4, window_idx=(0, 2),
                            rope=True, swiglu=True, drop_path=0.0, pos_grid=14),
    },
}
PORT_TABLES = {"resnet": resnet, "convnext": convnext, "swin": swin, "focalnet": focalnet, "vit": vit}
JAX_TABLES = {"resnet": jax_resnet, "convnext": jax_convnext, "swin": jax_swin, "focalnet": jax_focalnet,
              "vit": jax_vit}


@pytest.fixture
def tiny_archs(monkeypatch):
    for family, archs in TINY_ARCHS.items():
        for name, arch in archs.items():
            monkeypatch.setitem(PORT_TABLES[family].ARCH_SETTINGS, name, arch)
            monkeypatch.setitem(JAX_TABLES[family].ARCH_SETTINGS, name, arch)


def jax_backbone(arch, idx):
    if arch.startswith(("resnet", "resnext", "wide_resnet")):
        return jax_resnet.ResNetBackbone(arch=arch, return_indices=idx)
    if arch.startswith("conv"):
        return jax_convnext.ConvNeXtBackbone(arch=arch, return_indices=idx)
    if arch.startswith("swin"):
        return jax_swin.SwinTransformerBackbone(arch=arch, return_indices=idx)
    if arch.startswith("focalnet"):
        return jax_focalnet.FocalNetBackbone(arch=arch, return_indices=idx)
    return jax_vit.VisionTransformerBackbone(arch=arch, return_indices=idx, out_channels=24)


def backbone_variables(jmod, x, seed):
    """Random variables of the JAX module, layer scales raised to 0.5-1 so
    that every block's branch shows in the output."""
    variables = random_variables(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x)), seed)
    rng = np.random.default_rng(seed + 1)

    def boost(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                boost(v)
            elif k in ("gamma", "gamma_1", "gamma_2"):
                tree[k] = rng.uniform(0.5, 1.0, v.shape).astype(np.float32)

    boost(variables)
    return variables


def compare_backbone(arch, idx, canvas, seed=0, rules=None):
    jmod = jax_backbone(arch, idx)
    x = np.random.default_rng(seed).normal(size=(2, *canvas, 3)).astype(np.float32)
    variables = backbone_variables(jmod, jnp.asarray(x), seed)
    jax_vit.rope_tables.cache_clear()  # it caches arrays; eval_shape left tracers there
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    rules = rules or weight_rules.backbone_rules(arch)
    nested = {col: {"backbone": tree} for col, tree in variables.items()}
    cfg = SalienceDETRConfig(backbone=arch, backbone_return_indices=idx, embed_dim=24)
    module = build_backbone(cfg).eval()
    module.load_state_dict(export_subtree(nested, rules, "backbone."), strict=True)
    with torch.no_grad():
        got = module(t(x).permute(0, 3, 1, 2).contiguous())
    assert sorted(got) == sorted(want) == sorted(idx)
    assert module.num_channels == list(jmod.num_channels)
    for i in idx:
        np.testing.assert_allclose(got[i].permute(0, 2, 3, 1).numpy(), np.asarray(want[i]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{arch} level {i}")
    return got


@pytest.mark.parametrize("arch,idx,canvas", [
    ("resnext_tiny", (1, 2, 3), (64, 48)),
    ("wide_resnet_tiny", (0, 1, 2, 3), (64, 48)),
    ("conv_tiny", (1, 2, 3), (64, 80)),
    ("conv_tiny", (0, 1, 2, 3), (72, 52)),  # "SAME" padding of the stem and downsampling convs
    ("swin_tiny", (1, 2, 3), (64, 80)),  # padded windows, a shift, and one window covering stage 3
    ("swin_tiny", (0, 1, 2, 3), (96, 128)),
    ("swin_v2_tiny", (1, 2, 3), (64, 80)),
    ("focalnet_tiny_plain", (1, 2, 3), (64, 80)),
    ("focalnet_tiny_conv", (1, 2, 3), (64, 80)),
    ("focalnet_tiny_ln", (1, 2, 3), (72, 52)),
])
def test_backbone_matches_jax(tiny_archs, arch, idx, canvas):
    compare_backbone(arch, idx, canvas)


@pytest.mark.parametrize("arch", ["vit_tiny", "eva_02_tiny"])
@pytest.mark.parametrize("canvas", [(96, 128), (256, 320)])
def test_vit_backbone_and_pyramid_match_jax(tiny_archs, arch, canvas):
    """Every pyramid level (0-4) at a token grid smaller than the 14 x 14
    position table on one side (6 x 8: the resize shrinks with antialiasing,
    as jax.image.resize does) and larger (16 x 20)."""
    idx = (0, 1, 2, 3, 4)
    got = compare_backbone(arch, idx, canvas, rules=weight_rules._vit_rules(arch, idx))
    h, w = canvas[0] // 16, canvas[1] // 16
    assert tuple(got[2].shape[-2:]) == (h, w) and tuple(got[0].shape[-2:]) == (4 * h, 4 * w)


def test_swin_masks_and_indices_equal_jax():
    for window in (3, 7):
        np.testing.assert_array_equal(swin.relative_position_index(window),
                                      jax_swin.relative_position_index(window))
        np.testing.assert_array_equal(swin.relative_coords_table(window), jax_swin.relative_coords_table(window))
        for hp, wp in ((2 * window, 3 * window), (4 * window, 2 * window)):
            np.testing.assert_array_equal(swin.shifted_window_mask(hp, wp, window, window // 2),
                                          jax_swin.shifted_window_mask(hp, wp, window, window // 2))
    for hh, ww in ((16, 16), (50, 84), (6, 8)):
        for got, want in zip(vit.rope_tables(hh, ww, 64), jax_vit.rope_tables(hh, ww, 64)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    x = np.random.default_rng(0).normal(size=(3, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(vit.rotate_half(t(x)).numpy(), np.asarray(jax_vit.rotate_half(jnp.asarray(x))))


def test_swin_buffers_are_not_state():
    """The index and coordinate tables are non-persistent buffers: no state
    dict key, but they follow the module to its device."""
    module = swin.SwinTransformerBackbone("swin_v2_t")
    keys = module.state_dict().keys()
    assert not any(k.endswith(("relative_position_index", "relative_coords_table")) for k in keys)
    names = {n for n, _ in module.named_buffers()}
    assert "0.features.1.0.attn.relative_position_index" in names
    assert "0.features.1.0.attn.relative_coords_table" in names


# ------------------------------------------------------------ rules, state


ALL_ARCHS = (list(resnet.ARCH_SETTINGS) + list(convnext.ARCH_SETTINGS) + list(swin.ARCH_SETTINGS)
             + list(focalnet.ARCH_SETTINGS) + list(vit.ARCH_SETTINGS))


def test_arch_tables_equal_jax():
    for family, module in PORT_TABLES.items():
        assert module.ARCH_SETTINGS == JAX_TABLES[family].ARCH_SETTINGS, family


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_equal_the_jax_converters(arch):
    assert weight_rules.backbone_rules(arch) == jax_wc.backbone_rules(arch)
    assert weight_rules.salience_detr_rules(arch, num_levels=5) == jax_wc.salience_detr_rules(arch, num_levels=5)


def test_family_rules_and_transforms_equal_the_jax_converters():
    assert weight_rules._focalnet_rules((1, 2, 3, 1), (2, 3, 4, 2), (0, 1, 2, 3), False, True) == \
        jax_wc._focalnet_rules((1, 2, 3, 1), (2, 3, 4, 2), (0, 1, 2, 3), False, True)
    for arch in ("vit_b", "eva_02_vit_b_4attn_1024"):
        for idx in ((0, 1, 2, 3, 4), (2, 3), (1, 2, 3, 4)):
            assert weight_rules._vit_rules(arch, idx) == jax_wc._vit_rules(arch, idx)
    rng = np.random.default_rng(0)
    for kind, shape in (("flatten", (7,)), ("deconv", (2, 2, 6, 4)), ("vit_pos", (5, 5, 3))):
        value = rng.normal(size=shape).astype(np.float32)
        inverse = weight_rules._invert_transform(value, kind)
        np.testing.assert_array_equal(inverse, jax_wc._invert_transform(value, kind))
        np.testing.assert_array_equal(jax_wc._apply_transform(inverse, kind), value)


@pytest.mark.parametrize("arch", ["resnext_tiny", "conv_tiny", "swin_tiny", "swin_v2_tiny", "focalnet_tiny_conv",
                                  "focalnet_tiny_ln", "vit_tiny", "eva_02_tiny"])
def test_param_groups_equal_the_jax_classifiers(tiny_archs, arch):
    """Every grouping's group of every trainable parameter is the JAX
    classifier's on the variable it converts to; e.g. Swin v2's qkv bias
    (JAX ``qkv_bias``) decays, FocalNet's modulation ``ln`` decays, EVA-02's
    ``ln_1`` decays and its ``q_bias`` does not."""
    cfg = SalienceDETRConfig(**dict(TINY_TORCH, backbone=arch))
    model, _ = build_salience_detr(cfg, torch.device("cpu"))
    paths = {}
    for src, dst, _ in converter_rules(cfg):
        if dst.startswith("params/"):
            paths.setdefault(src, []).append(tuple(jax.tree_util.DictKey(c) for c in dst.split("/")[1:]))
    assert {n for n, p in model.named_parameters()} == set(paths)
    for grouping, (classify, _, _) in jax_optim.PARAM_GROUPINGS.items():
        groups = named_param_groups(model, grouping)
        assert len(groups) == sum(p.requires_grad for p in model.parameters())
        for name, group in groups.items():
            assert {classify(p) for p in paths[name]} == {group}, (grouping, name)
        assert PARAM_GROUPINGS[grouping][1:] == jax_optim.PARAM_GROUPINGS[grouping][1:]
    groups = named_param_groups(model)
    named = {
        "swin_v2_tiny": {"backbone.0.features.1.0.attn.qkv.bias": "backbone"},
        "focalnet_tiny_ln": {"backbone.0.layers.0.blocks.0.modulation.ln.weight": "backbone",
                             "backbone.0.layers.0.blocks.0.norm1.weight": "backbone_norm"},
        "eva_02_tiny": {"backbone.0.encoder.layers.encoder_layer_0.ln_1.weight": "backbone",
                        "backbone.0.encoder.layers.encoder_layer_0.self_attention.q_bias": "backbone_norm"},
        "swin_tiny": {"backbone.0.features.1.0.attn.relative_position_bias_table": "backbone"},
        "conv_tiny": {"backbone.features.1.0.layer_scale": "backbone",
                      "backbone.features.0.1.weight": "backbone_norm"},
    }.get(arch, {})
    for name, group in named.items():
        assert groups[name] == group, name
    # only a ResNet freezes stages (the JAX predicate names ResNet modules)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert bool(frozen) == arch.startswith("resnext")


# ------------------------------------------------------------ stochastic depth


def test_drop_path_rows_scale_and_generator():
    """Train mode: whole rows dropped, the rest scaled by 1 / keep, drawn
    from the given generator alone; eval mode and p = 0: the identity; no
    generator: an error."""
    x = torch.randn(64, 3, 4, 5, generator=torch.Generator().manual_seed(0)) + 5.0
    layer = DropPath(0.3).train()
    with pytest.raises(RuntimeError, match="generator"):
        layer(x)
    layer.generator = torch.Generator().manual_seed(1)
    y = layer(x)
    ratio = (y / x).reshape(64, -1)
    kept = ratio[:, 0] != 0
    assert torch.all((ratio == 0).all(1) | torch.isclose(ratio, torch.tensor(1 / 0.7)).all(1))
    assert 0 < int(kept.sum()) < 64
    torch.manual_seed(123)
    layer.generator = torch.Generator().manual_seed(1)
    assert torch.equal(layer(x), y)
    assert torch.equal(DropPath(0.3).eval()(x), x) and torch.equal(DropPath(0.0).train()(x), x)
    tokens = torch.ones(8, 5, 3)
    layer.generator = torch.Generator().manual_seed(2)
    out = layer(tokens)
    assert all(len(set(out[b].flatten().tolist())) == 1 for b in range(8))


def test_drop_path_schedules_are_the_jax_ones(tiny_archs):
    """ConvNeXt, Swin and FocalNet: sd * k / (total - 1) over all blocks;
    EVA-02: linspace(0, drop_path, depth); set_drop_path_generator reaches
    every DropPath."""
    def rates(module):
        return [m.p for m in module.modules() if isinstance(m, DropPath)]

    conv = convnext.ConvNeXtBackbone("conv_l")
    assert rates(conv) == pytest.approx(linear_drop_rates(0.5, (3, 3, 27, 3)))
    assert rates(conv)[-1] == pytest.approx(0.5) and rates(conv)[1] == pytest.approx(0.5 / 35)
    sw = swin.SwinTransformerBackbone("swin_t")
    assert rates(sw) == pytest.approx([0.2 * k / 11 for k in range(12)])
    fn = focalnet.FocalNetBackbone("focalnet_tiny_srf")
    assert rates(fn) == pytest.approx([0.2 * k / 11 for k in range(12)])
    eva = vit.VisionTransformerBackbone("eva_02_vit_b_4attn_1024")
    assert rates(eva) == pytest.approx(list(np.linspace(0, 0.1, 12)))
    assert not rates(vit.VisionTransformerBackbone("vit_tiny"))
    gen = torch.Generator()
    set_drop_path_generator(eva, gen)
    assert all(m.generator is gen for m in eva.modules() if isinstance(m, DropPath))


# ------------------------------------------------------------ bare files


@pytest.mark.parametrize("arch", ["resnext_tiny", "conv_tiny", "swin_tiny", "swin_v2_tiny", "focalnet_tiny_conv",
                                  "eva_02_tiny"])
def test_bare_backbone_file_loads_every_tensor(tiny_archs, tmp_path, arch):
    """A backbone file in the family's bare upstream layout (no wrapper
    prefix; a ``module.`` prefix; a classifier head the detector lacks; for
    Swin, torchvision's attention buffers; for ViT, a position table with a
    class-token slot) loads every backbone tensor of the detector."""
    cfg = SalienceDETRConfig(**dict(TINY_TORCH, backbone=arch))
    source, _ = build_salience_detr(cfg, torch.device("cpu"), torch.Generator().manual_seed(9))
    model, _ = build_salience_detr(cfg, torch.device("cpu"), torch.Generator().manual_seed(1))
    body = "backbone." + model.backbone.weights_prefix
    want = {k: v + 0.5 for k, v in source.state_dict().items() if k.startswith(body)}
    bare = {"module." + k[len(body):]: v for k, v in want.items()}
    bare["module.head.weight"] = torch.zeros(1000, 8)
    extra = 1
    if arch.startswith("swin"):
        bare["module.features.1.0.attn.relative_position_index"] = torch.zeros(9 * 9, dtype=torch.long)
        extra += 1
    if arch.startswith("eva"):
        pos = bare["module.encoder.pos_embedding"]
        bare["module.encoder.pos_embedding"] = torch.cat([torch.full_like(pos[:, :1], 7.0), pos], 1)
    path = tmp_path / "imagenet.pth"
    torch.save(bare, path)
    before = model.state_dict()
    applied = load_backbone_weights(model, str(path))
    assert applied == len(bare) - extra == len(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k] if k in want else before[k]), k


# ------------------------------------------------------------ C-18


def test_grid_nms_plain_past_the_kernels_shared_memory_matches_jax():
    """The 5-scale levels of a 1344 x 1344 canvas (S = 149,940; 13K + 2S + 1
    is past the kernel's shared memory, which the wrapper now serves from a
    global-memory rank map; the 800 x 1344 5-scale levels still fit): the
    plain version, and the wrapper on a CPU tensor, against the JAX
    function."""
    levels = [(336, 336), (168, 168), (84, 84), (42, 42)]
    S = sum(h * w for h, w in levels)
    rng = np.random.default_rng(5)
    topk = np.stack([rng.permutation(S)[:3600] for _ in range(2)]).astype(np.int32)
    topk[1, :400] = np.arange(400)  # a raster clump on level 0
    assert grid_nms_rank_in_global(3600, S) and not grid_nms_rank_in_global(3600, 89250)
    want = np.asarray(jax.vmap(lambda k: jax_nms.grid_nms_topk(k, levels, 900))(jnp.asarray(topk)))
    got = grid_nms_topk_plain(t(topk), levels, 900)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(grid_nms_topk(t(topk), levels, 900).numpy(), want)


def test_nms_keep_plain_at_2048_boxes_matches_jax():
    rng = np.random.default_rng(6)
    xy = rng.uniform(0, 200, size=(2, 2048, 2)).astype(np.float32)
    wh = rng.uniform(5, 60, size=(2, 2048, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[0, 100:110] = boxes[0, 99]  # identical boxes
    want = np.stack([np.asarray(jax_nms.nms_keep_mask(jnp.asarray(b), 0.5)) for b in boxes])
    got = nms_keep_mask_plain(t(boxes), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    # past the walking block's shared memory: the card reads the rows remotely
    assert 0 < int(got.sum()) < got.numel() and nms_keep_plan(boxes.shape[1])[0] == "remote"
    np.testing.assert_array_equal(nms_keep_mask(t(boxes), 0.5).numpy(), want)
