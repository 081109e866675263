"""The weight converter's naming rules and its inverse transform, for the
weights bridge (``weights.py``).

A rule is ``(torch_name, flax_path, transform)``: the upstream PyTorch
state-dict key, the JAX package's variable path, and how the array's layout
changes between the two.  These are the JAX package's own rules
(salience_detr_tpu/utils/weight_converter.py: the helpers, ``_resnet_rules``,
``salience_detr_head_rules``, ``_invert_transform`` and
``export_torch_state_dict``), kept here in numpy so that the port reads no
file of that package; tests/test_torch_port_weights.py holds the two copies
equal.
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


def _invert_transform(value: np.ndarray, kind: str) -> np.ndarray:
    """A JAX variable -> the upstream-layout array whose conversion gives it
    back (the kinds the ResNet and head rules use)."""
    if kind == "copy":
        return value
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
