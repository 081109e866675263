"""The weight converter's naming rules and its inverse transform, for the
weights bridge (``weights.py``).

A rule is ``(torch_name, flax_path, transform)``: the upstream PyTorch
state-dict key, the JAX package's variable path, and how the array's layout
changes between the two.  These are the JAX package's own rules
(salience_detr_tpu/utils/weight_converter.py: the helpers, the backbone
families' rules, ``backbone_rules``, ``salience_detr_head_rules``,
``salience_detr_rules``, ``_invert_transform`` and
``export_torch_state_dict``), kept here in numpy so that the port reads no
file of that package; tests/test_torch_port_weights.py and
tests/test_torch_port_backbones.py hold the two copies equal.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Rule = Tuple[str, str, str]


def _conv(src: str, dst: str) -> List[Rule]:
    return [(f"{src}.weight", f"params/{dst}/kernel", "conv")]


def _linear(src: str, dst: str, bias: bool = True) -> List[Rule]:
    out = [(f"{src}.weight", f"params/{dst}/kernel", "linear")]
    if bias:
        out.append((f"{src}.bias", f"params/{dst}/bias", "copy"))
    return out


def _ln(src: str, dst: str) -> List[Rule]:
    return [
        (f"{src}.weight", f"params/{dst}/scale", "copy"),
        (f"{src}.bias", f"params/{dst}/bias", "copy"),
    ]


def _frozen_bn(src: str, dst: str) -> List[Rule]:
    return [
        (f"{src}.weight", f"frozen/{dst}/scale", "copy"),
        (f"{src}.bias", f"frozen/{dst}/bias", "copy"),
        (f"{src}.running_mean", f"frozen/{dst}/mean", "copy"),
        (f"{src}.running_var", f"frozen/{dst}/var", "copy"),
    ]


def _bn(src: str, dst: str) -> List[Rule]:
    return [
        (f"{src}.weight", f"params/{dst}/scale", "copy"),
        (f"{src}.bias", f"params/{dst}/bias", "copy"),
        (f"{src}.running_mean", f"batch_stats/{dst}/mean", "copy"),
        (f"{src}.running_var", f"batch_stats/{dst}/var", "copy"),
    ]


def _mha(src: str, dst: str) -> List[Rule]:
    """nn.MultiheadAttention's merged in_proj -> separate q/k/v projections."""
    rules = []
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        rules.append((f"{src}.in_proj_weight", f"params/{dst}/{name}/kernel", f"inproj_w{i}"))
        rules.append((f"{src}.in_proj_bias", f"params/{dst}/{name}/bias", f"inproj_b{i}"))
    rules += [
        (f"{src}.out_proj.weight", f"params/{dst}/out_proj/kernel", "linear"),
        (f"{src}.out_proj.bias", f"params/{dst}/out_proj/bias", "copy"),
    ]
    return rules


def _msdeform(src: str, dst: str) -> List[Rule]:
    rules = []
    for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        rules += _linear(f"{src}.{name}", f"{dst}/{name}")
    return rules


def _mlp(src: str, dst: str, n: int) -> List[Rule]:
    rules = []
    for i in range(n):
        rules += _linear(f"{src}.layers.{i}", f"{dst}/layers_{i}")
    return rules


def _dcn_pack(src: str, dst: str) -> List[Rule]:
    """DeformConv2dPack: offset and mask convs with bias, and the kernel
    without one (the ResNet's conv3x3_dcn)."""
    rules = []
    for part in ("conv_offset", "conv_mask"):
        rules += _conv(f"{src}.{part}", f"{dst}/{part}")
        rules += [(f"{src}.{part}.bias", f"params/{dst}/{part}/bias", "copy")]
    rules += [(f"{src}.deform_conv2d.weight", f"params/{dst}/kernel", "dcn_kernel")]
    return rules


def _resnet_rules(
    layers: Tuple[int, ...] = (3, 4, 6, 3),
    bottleneck: bool = True,
    stage_with_dcn: Tuple[bool, ...] = (False, False, False, False),
) -> List[Rule]:
    rules = _conv("backbone.conv1", "backbone/conv1") + _frozen_bn("backbone.bn1", "backbone/bn1")
    n_convs = 3 if bottleneck else 2
    for s in range(4):
        for b in range(layers[s]):
            src = f"backbone.layer{s + 1}.{b}"
            dst = f"backbone/layer{s + 1}_{b}"
            for c in range(1, n_convs + 1):
                if c == 2 and stage_with_dcn[s]:
                    rules += _dcn_pack(f"{src}.conv2", f"{dst}/conv2")
                else:
                    rules += _conv(f"{src}.conv{c}", f"{dst}/conv{c}")
                rules += _frozen_bn(f"{src}.bn{c}", f"{dst}/bn{c}")
            if b == 0 and (s > 0 or bottleneck):
                rules += _conv(f"{src}.downsample.0", f"{dst}/downsample_conv")
                rules += _frozen_bn(f"{src}.downsample.1", f"{dst}/downsample_bn")
    return rules


def _convnext_rules(depths: Tuple[int, ...] = (3, 3, 27, 3), prefix: str = "backbone") -> List[Rule]:
    """torchvision ConvNeXt: the stem at features.0.{0 conv, 1 norm}; stage s
    blocks at features.{2s+1}.{b}.block.{0 dwconv, 2 norm, 3 pwconv1, 5
    pwconv2} and .layer_scale; downsample s >= 1 at features.{2s}.{0 norm, 1
    conv}."""
    rules = _conv(f"{prefix}.features.0.0", "backbone/stem_conv")
    rules += [(f"{prefix}.features.0.0.bias", "params/backbone/stem_conv/bias", "copy")]
    rules += _ln(f"{prefix}.features.0.1", "backbone/stem_norm")
    for s in range(4):
        if s > 0:
            rules += _ln(f"{prefix}.features.{2 * s}.0", f"backbone/downsample_norm{s}")
            rules += _conv(f"{prefix}.features.{2 * s}.1", f"backbone/downsample_conv{s}")
            rules += [(f"{prefix}.features.{2 * s}.1.bias", f"params/backbone/downsample_conv{s}/bias", "copy")]
        for b in range(depths[s]):
            src = f"{prefix}.features.{2 * s + 1}.{b}"
            dst = f"backbone/stage{s}_block{b}"
            rules += _conv(f"{src}.block.0", f"{dst}/dwconv")
            rules += [(f"{src}.block.0.bias", f"params/{dst}/dwconv/bias", "copy")]
            rules += _ln(f"{src}.block.2", f"{dst}/norm")
            rules += _linear(f"{src}.block.3", f"{dst}/pwconv1")
            rules += _linear(f"{src}.block.5", f"{dst}/pwconv2")
            rules += [(f"{src}.layer_scale", f"params/{dst}/gamma", "flatten")]
    return rules


def _swin_rules(depths: Tuple[int, ...] = (2, 2, 18, 2), prefix: str = "backbone.0", v2: bool = False) -> List[Rule]:
    """torchvision Swin under the wrapper's index 0: patch embed
    features.0.{0 conv, 2 norm}; stage s blocks at features.{2s+1}.{b}.{norm1,
    attn.{qkv, proj, relative_position_bias_table}, norm2, mlp.{0, 3}};
    PatchMerging s >= 1 at features.{2s}.{reduction, norm}.  v2 has {logit_scale,
    cpb_mlp.{0, 2}} for the table and the qkv bias as its own variable."""
    rules = _conv(f"{prefix}.features.0.0", "backbone/patch_embed")
    rules += [(f"{prefix}.features.0.0.bias", "params/backbone/patch_embed/bias", "copy")]
    rules += _ln(f"{prefix}.features.0.2", "backbone/patch_norm")
    for s in range(4):
        if s > 0:
            rules += _ln(f"{prefix}.features.{2 * s}.norm", f"backbone/merge{s}/norm")
            rules += _linear(f"{prefix}.features.{2 * s}.reduction", f"backbone/merge{s}/reduction", bias=False)
        for b in range(depths[s]):
            src = f"{prefix}.features.{2 * s + 1}.{b}"
            dst = f"backbone/stage{s}_block{b}"
            rules += _ln(f"{src}.norm1", f"{dst}/norm1")
            if v2:
                rules += _linear(f"{src}.attn.qkv", f"{dst}/attn/qkv", bias=False)
                rules += [
                    (f"{src}.attn.qkv.bias", f"params/{dst}/attn/qkv_bias", "copy"),
                    (f"{src}.attn.logit_scale", f"params/{dst}/attn/logit_scale", "copy"),
                ]
                rules += _linear(f"{src}.attn.cpb_mlp.0", f"{dst}/attn/cpb_mlp_0")
                rules += _linear(f"{src}.attn.cpb_mlp.2", f"{dst}/attn/cpb_mlp_2", bias=False)
            else:
                rules += _linear(f"{src}.attn.qkv", f"{dst}/attn/qkv")
                rules += [(f"{src}.attn.relative_position_bias_table",
                           f"params/{dst}/attn/relative_position_bias_table", "copy")]
            rules += _linear(f"{src}.attn.proj", f"{dst}/attn/proj")
            rules += _ln(f"{src}.norm2", f"{dst}/norm2")
            rules += _linear(f"{src}.mlp.0", f"{dst}/mlp_fc1")
            rules += _linear(f"{src}.mlp.3", f"{dst}/mlp_fc2")
    return rules


def _focalnet_rules(
    depths: Tuple[int, ...] = (2, 2, 18, 2),
    focal_levels: Tuple[int, ...] = (4, 4, 4, 4),
    return_indices: Tuple[int, ...] = (1, 2, 3),
    use_layerscale: bool = True,
    use_postln_in_modulation: bool = False,
    prefix: str = "backbone.0",
) -> List[Rule]:
    """FocalNet under the wrapper's index 0, and the per-level norms at
    backbone.1.norm{idx}."""
    rules = _conv(f"{prefix}.patch_embed.proj", "backbone/patch_embed/proj")
    rules += [(f"{prefix}.patch_embed.proj.bias", "params/backbone/patch_embed/proj/bias", "copy")]
    rules += _ln(f"{prefix}.patch_embed.norm", "backbone/patch_embed/norm")
    for s in range(4):
        for b in range(depths[s]):
            src = f"{prefix}.layers.{s}.blocks.{b}"
            dst = f"backbone/stage{s}_block{b}"
            rules += _ln(f"{src}.norm1", f"{dst}/norm1")
            rules += _linear(f"{src}.modulation.f", f"{dst}/modulation/f")
            rules += _conv(f"{src}.modulation.h", f"{dst}/modulation/h")
            rules += [(f"{src}.modulation.h.bias", f"params/{dst}/modulation/h/bias", "copy")]
            for k in range(focal_levels[s]):
                rules += _conv(f"{src}.modulation.focal_layers.{k}.0", f"{dst}/modulation/focal_layers_{k}")
            if use_postln_in_modulation:
                rules += _ln(f"{src}.modulation.ln", f"{dst}/modulation/ln")
            rules += _linear(f"{src}.modulation.proj", f"{dst}/modulation/proj")
            rules += _ln(f"{src}.norm2", f"{dst}/norm2")
            rules += _linear(f"{src}.mlp.fc1", f"{dst}/mlp_fc1")
            rules += _linear(f"{src}.mlp.fc2", f"{dst}/mlp_fc2")
            if use_layerscale:
                rules += [
                    (f"{src}.gamma_1", f"params/{dst}/gamma_1", "copy"),
                    (f"{src}.gamma_2", f"params/{dst}/gamma_2", "copy"),
                ]
        if s < 3:
            rules += _conv(f"{prefix}.layers.{s}.downsample.proj", f"backbone/downsample{s}/proj")
            rules += [(f"{prefix}.layers.{s}.downsample.proj.bias",
                       f"params/backbone/downsample{s}/proj/bias", "copy")]
            rules += _ln(f"{prefix}.layers.{s}.downsample.norm", f"backbone/downsample{s}/norm")
    for idx in return_indices:
        rules += _ln(f"backbone.1.norm{idx}", f"backbone/out_norm{idx}")
    return rules


def _vit_rules(arch: str, return_indices: Tuple[int, ...] = (1, 2, 3), prefix: str = "backbone.0") -> List[Rule]:
    """ViT / EVA-02 under the wrapper's index 0 (encoder blocks at
    encoder.layers.encoder_layer_{i}: merged in_proj and mlp.{0, 3} in ViT,
    separate q/k/v with standalone q/v biases and SwiGLU mlp.{w1, w2, ffn_ln,
    w3} in EVA-02) and the feature pyramid under index 1, stage_{idx+2} per
    returned index (index 4, the extra max pool, has no parameters)."""
    from salience_detr_torch.models.backbones.vit import ARCH_SETTINGS

    cfg = ARCH_SETTINGS[arch]
    rope = bool(cfg.get("rope"))
    rules = _conv(f"{prefix}.conv_proj", "backbone/patch_embed")
    rules += [(f"{prefix}.conv_proj.bias", "params/backbone/patch_embed/bias", "copy")]
    rules += [(f"{prefix}.encoder.pos_embedding", "params/backbone/pos_embed", "vit_pos")]
    for i in range(cfg["depth"]):
        src = f"{prefix}.encoder.layers.encoder_layer_{i}"
        dst = f"backbone/block{i}"
        attn = f"{src}.self_attention"
        if rope:
            rules += _ln(f"{src}.ln_1", f"{dst}/ln_1")
            rules += _linear(f"{attn}.q_proj", f"{dst}/q_proj", bias=False)
            rules += [(f"{attn}.q_bias", f"params/{dst}/q_proj/bias", "copy")]
            rules += _linear(f"{attn}.k_proj", f"{dst}/k_proj", bias=False)
            rules += _linear(f"{attn}.v_proj", f"{dst}/v_proj", bias=False)
            rules += [(f"{attn}.v_bias", f"params/{dst}/v_proj/bias", "copy")]
            rules += _linear(f"{attn}.proj", f"{dst}/proj")
            rules += _ln(f"{src}.ln_2", f"{dst}/ln_2")
            rules += _linear(f"{src}.mlp.w1", f"{dst}/w1")
            rules += _linear(f"{src}.mlp.w2", f"{dst}/w2")
            rules += _ln(f"{src}.mlp.ffn_ln", f"{dst}/ffn_ln")
            rules += _linear(f"{src}.mlp.w3", f"{dst}/w3")
        else:
            rules += _ln(f"{src}.ln_1", f"{dst}/norm1")
            rules += [
                (f"{attn}.in_proj_weight", f"params/{dst}/qkv/kernel", "linear"),
                (f"{attn}.in_proj_bias", f"params/{dst}/qkv/bias", "copy"),
            ]
            rules += _linear(f"{attn}.out_proj", f"{dst}/proj")
            rules += _ln(f"{src}.ln_2", f"{dst}/norm2")
            rules += _linear(f"{src}.mlp.0", f"{dst}/mlp_fc1")
            rules += _linear(f"{src}.mlp.3", f"{dst}/mlp_fc2")
    rules += _ln(f"{prefix}.encoder.ln", "backbone/norm")

    fpn = prefix.rsplit(".", 1)[0] + ".1" if "." in prefix else "backbone.1"
    for idx in return_indices:
        if idx == 4:
            continue
        stage = f"{fpn}.stage_{idx + 2}"
        if idx == 0:
            for j, name in ((0, "up4_deconv1"), (3, "up4_deconv2")):
                rules += [
                    (f"{stage}.{j}.weight", f"params/backbone/{name}/kernel", "deconv"),
                    (f"{stage}.{j}.bias", f"params/backbone/{name}/bias", "copy"),
                ]
            rules += _ln(f"{stage}.1", "backbone/up4_norm")
            cna0 = 4
        elif idx == 1:
            rules += [
                (f"{stage}.0.weight", "params/backbone/up2/kernel", "deconv"),
                (f"{stage}.0.bias", "params/backbone/up2/bias", "copy"),
            ]
            cna0 = 1
        elif idx == 2:
            cna0 = 0
        else:  # idx == 3: the max pool at 0
            cna0 = 1
        rules += _conv(f"{stage}.{cna0}.0", f"backbone/lateral{idx}")
        rules += _ln(f"{stage}.{cna0}.1", f"backbone/lateral_norm{idx}")
        rules += _conv(f"{stage}.{cna0 + 1}.0", f"backbone/out{idx}")
        rules += _ln(f"{stage}.{cna0 + 1}.1", f"backbone/out_norm{idx}")
    return rules


def _conv_bn_act(src: str, dst: str) -> List[Rule]:
    """RepVGG-PluX ConvNormAct: sequential 0 = conv, 1 = BatchNorm."""
    return _conv(f"{src}.0", f"{dst}/conv") + _bn(f"{src}.1", f"{dst}/bn")


def _se(src: str, dst: str) -> List[Rule]:
    return (
        _conv(f"{src}.conv_mask", f"{dst}/conv_mask")
        + [(f"{src}.conv_mask.bias", f"params/{dst}/conv_mask/bias", "copy")]
        + _conv(f"{src}.se_module.0", f"{dst}/se_reduce")
        + _conv(f"{src}.se_module.2", f"{dst}/se_expand")
    )


def _repvgg_block(src: str, dst: str, identity_conv: bool) -> List[Rule]:
    rules = _conv_bn_act(f"{src}.conv1", f"{dst}/conv1")
    rules += _conv_bn_act(f"{src}.conv2", f"{dst}/conv2")
    rules += _se(f"{src}.se_module", f"{dst}/se_module")
    if identity_conv:
        rules += _conv(f"{src}.identity", f"{dst}/identity")
        rules += [(f"{src}.identity.bias", f"params/{dst}/identity/bias", "copy")]
    return rules


def _csp_layer(src: str, dst: str, num_blocks: int = 3, conv3: bool = False) -> List[Rule]:
    rules = _conv_bn_act(f"{src}.conv1", f"{dst}/conv1")
    rules += _conv_bn_act(f"{src}.conv2", f"{dst}/conv2")
    for i in range(num_blocks):
        rules += _repvgg_block(f"{src}.bottlenecks.{i}", f"{dst}/bottlenecks_{i}", False)
    if conv3:
        rules += _conv_bn_act(f"{src}.conv3", f"{dst}/conv3")
    return rules


def _repnet_rules(src: str, dst: str, num_levels: int = 4) -> List[Rule]:
    rules = []
    for i in range(num_levels - 1):
        rules += _conv_bn_act(f"{src}.lateral_convs.{i}", f"{dst}/lateral_convs_{i}")
        rules += _csp_layer(f"{src}.layer_blocks.{i}", f"{dst}/layer_blocks_{i}")
        rules += _conv_bn_act(f"{src}.downsample_blocks.{i}", f"{dst}/downsample_blocks_{i}")
        rules += _csp_layer(f"{src}.pan_blocks.{i}", f"{dst}/pan_blocks_{i}")
    return rules


def salience_detr_head_rules(
    num_encoder_layers: int = 6,
    num_decoder_layers: int = 6,
    num_levels: int = 4,
    num_channel_mapper_convs: int = 4,
) -> List[Rule]:
    """Rules for everything above the backbone: neck, transformer, heads,
    denoising."""
    rules = []
    # ChannelMapper: convs.{i}.0 conv (no bias), convs.{i}.1 GroupNorm
    for i in range(num_channel_mapper_convs):
        rules += _conv(f"neck.convs.{i}.0", f"neck/convs_{i}/conv")
        rules += [
            (f"neck.convs.{i}.1.weight", f"params/neck/convs_{i}/gn/GroupNorm_0/scale", "copy"),
            (f"neck.convs.{i}.1.bias", f"params/neck/convs_{i}/gn/GroupNorm_0/bias", "copy"),
        ]

    t = "transformer"
    rules += [
        (f"{t}.level_embeds", f"params/{t}/level_embeds", "copy"),
        (f"{t}.alpha", f"params/{t}/alpha", "copy"),
        (f"{t}.tgt_embed.weight", f"params/{t}/tgt_embed", "copy"),
        ("denoising_generator.label_encoder.weight",
         "params/denoising_generator/label_encoder", "copy"),
        (f"{t}.encoder.background_embedding.row_embed.weight",
         f"params/{t}/background_row_embed", "copy"),
        (f"{t}.encoder.background_embedding.col_embed.weight",
         f"params/{t}/background_col_embed", "copy"),
    ]
    rules += _linear(f"{t}.enc_output", f"{t}/enc_output")
    rules += _ln(f"{t}.enc_output_norm", f"{t}/enc_output_norm")
    rules += _linear(f"{t}.encoder_class_head", f"{t}/encoder_class_head")
    rules += _mlp(f"{t}.encoder_bbox_head", f"{t}/encoder_bbox_head", 3)

    # MaskPredictor: layer1 = [LN, Linear, GELU]; layer2 = [Lin, GELU, Lin, GELU, Lin]
    mp_src, mp_dst = f"{t}.enc_mask_predictor", f"{t}/enc_mask_predictor"
    rules += _ln(f"{mp_src}.layer1.0", f"{mp_dst}/norm")
    rules += _linear(f"{mp_src}.layer1.1", f"{mp_dst}/layer1")
    rules += _linear(f"{mp_src}.layer2.0", f"{mp_dst}/layer2_0")
    rules += _linear(f"{mp_src}.layer2.2", f"{mp_dst}/layer2_1")
    rules += _linear(f"{mp_src}.layer2.4", f"{mp_dst}/layer2_2")

    for i in range(num_encoder_layers):
        src = f"{t}.encoder.layers.{i}"
        dst = f"{t}/encoder_layer_{i}"
        rules += _mha(f"{src}.pre_attention", f"{dst}/pre_attention")
        rules += _ln(f"{src}.pre_norm", f"{dst}/pre_norm")
        rules += _msdeform(f"{src}.self_attn", f"{dst}/self_attn")
        rules += _ln(f"{src}.norm1", f"{dst}/norm1")
        rules += _linear(f"{src}.linear1", f"{dst}/linear1")
        rules += _linear(f"{src}.linear2", f"{dst}/linear2")
        rules += _ln(f"{src}.norm2", f"{dst}/norm2")

    rules += _repnet_rules(f"{t}.neck", f"{t}/neck", num_levels)

    rules += _mlp(f"{t}.decoder.ref_point_head", f"{t}/ref_point_head", 2)
    rules += _ln(f"{t}.decoder.norm", f"{t}/decoder_norm")
    for i in range(num_decoder_layers):
        src = f"{t}.decoder.layers.{i}"
        dst = f"{t}/decoder_layer_{i}"
        rules += _mha(f"{src}.self_attn", f"{dst}/self_attn")
        rules += _ln(f"{src}.norm2", f"{dst}/norm2")
        rules += _msdeform(f"{src}.cross_attn", f"{dst}/cross_attn")
        rules += _ln(f"{src}.norm1", f"{dst}/norm1")
        rules += _linear(f"{src}.linear1", f"{dst}/linear1")
        rules += _linear(f"{src}.linear2", f"{dst}/linear2")
        rules += _ln(f"{src}.norm3", f"{dst}/norm3")
        rules += _linear(f"{t}.decoder.class_head.{i}", f"{t}/class_head_{i}")
        rules += _mlp(f"{t}.decoder.bbox_head.{i}", f"{t}/bbox_head_{i}", 3)
    return rules


def backbone_rules(backbone: str = "resnet50",
                   stage_with_dcn: Tuple[bool, ...] = (False, False, False, False)) -> List[Rule]:
    """The backbone's rules (torch names with the detector's ``backbone.``
    prefix), by family."""
    if backbone.startswith(("resnet", "resnext", "wide_resnet")):
        from salience_detr_torch.models.backbones.resnet import ARCH_SETTINGS
        cfg = ARCH_SETTINGS[backbone]
        return _resnet_rules(cfg["layers"], cfg["block"] == "bottleneck", stage_with_dcn)
    if backbone.startswith("conv_"):
        from salience_detr_torch.models.backbones.convnext import ARCH_SETTINGS
        return _convnext_rules(ARCH_SETTINGS[backbone]["depths"])
    if backbone.startswith("swin"):
        from salience_detr_torch.models.backbones.swin import ARCH_SETTINGS
        cfg = ARCH_SETTINGS[backbone]
        return _swin_rules(cfg["depths"], v2=bool(cfg.get("v2", False)))
    if backbone.startswith(("vit", "eva")):
        return _vit_rules(backbone)
    if backbone.startswith("focalnet"):
        from salience_detr_torch.models.backbones.focalnet import ARCH_SETTINGS
        cfg = ARCH_SETTINGS[backbone]
        return _focalnet_rules(
            cfg["depths"], cfg["focal_levels"], return_indices=(1, 2, 3), use_layerscale=cfg["layerscale"],
            use_postln_in_modulation=cfg.get("postln_in_mod", False),
        )
    raise ValueError(f"no converter rules for backbone {backbone!r}")


def salience_detr_rules(backbone: str = "resnet50",
                        stage_with_dcn: Tuple[bool, ...] = (False, False, False, False), **head_kw) -> List[Rule]:
    """Whole-detector rules for any backbone family."""
    return backbone_rules(backbone, stage_with_dcn) + salience_detr_head_rules(**head_kw)


def _invert_transform(value: np.ndarray, kind: str) -> np.ndarray:
    """A JAX variable -> the upstream-layout array whose conversion gives it
    back."""
    if kind == "copy":
        return value
    if kind == "flatten":  # ConvNeXt's layer scale (C,) -> (C, 1, 1)
        return value.reshape(value.shape[0], 1, 1)
    if kind == "deconv":  # (kH, kW, in, out) -> ConvTranspose2d's (in, out, kH, kW)
        return np.transpose(value, (2, 3, 0, 1))
    if kind == "vit_pos":  # (g, g, C) -> (1, g * g, C), no class-token slot
        g, g2, c = value.shape
        assert g == g2, value.shape
        return value.reshape(1, g * g, c)
    if kind == "conv":  # HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if kind == "linear":  # (in, out) -> (out, in)
        return np.transpose(value, (1, 0))
    if kind == "dcn_kernel":  # (K*K, Cin, F), taps row-major -> OIHW (F, Cin, K, K)
        kk, cin, f = value.shape
        k = int(round(kk ** 0.5))
        return np.transpose(value.reshape(k, k, cin, f), (3, 2, 0, 1))
    raise ValueError(f"non-invertible transform kind: {kind}")


def flatten_variables(variables: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested variable dict -> {"collection/a/b": array}."""
    out = {}
    for k, v in variables.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_variables(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def export_torch_state_dict(
    variables: Dict, rules: List[Rule]
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """JAX variables -> an upstream-layout state dict of numpy arrays, and the
    rule targets missing from the variables (skipped).  The merged
    nn.MultiheadAttention in_proj tensors are reassembled from their q/k/v
    splits, in that order."""
    flat = flatten_variables(variables)
    by_src: Dict[str, List[Tuple[str, str]]] = {}
    for src, dst, kind in rules:
        by_src.setdefault(src, []).append((dst, kind))
    state: Dict[str, np.ndarray] = {}
    skipped: List[str] = []
    for src, entries in by_src.items():
        if entries[0][1].startswith("inproj"):
            entries = sorted(entries, key=lambda e: e[1])
            if any(dst not in flat for dst, _ in entries):
                skipped += [dst for dst, _ in entries if dst not in flat]
                continue
            parts = [
                np.transpose(flat[dst], (1, 0)) if kind.startswith("inproj_w") else flat[dst]
                for dst, kind in entries
            ]
            state[src] = np.concatenate(parts, axis=0)
        else:
            (dst, kind), = entries
            if dst not in flat:
                skipped.append(dst)
                continue
            state[src] = _invert_transform(flat[dst].astype(np.float32), kind)
    return state, skipped
