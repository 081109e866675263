"""Where the flagship's float32 outputs first part between the port and the
JAX package, on the inputs of ``tests/test_torch_port_flagship_parity.py``
(full width and depth, B=2 on the 128 x 352 canvas, seed-20 variables,
seed-21 images), and why.

    JAX_PLATFORMS=cpu python -m tests.flagship_parity_walk

Prints, in the forward's order, each module output of both packages in
float32 ulps (the largest and the median gap, and the share of elements
that differ), then each parting module alone on the JAX package's own input
to it (what the module's own arithmetic adds), then the encoder class head
in float64 on each side's float32 input.  About a minute on a CPU (the JAX
forward compiles for about 30 s)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.factory import build_salience_detr
from salience_detr_torch.weights import state_dict_from_jax
from tests.test_torch_port_flagship_parity import CANVAS, PADDED
from tests.torch_port_common import jax_variable_shapes, random_variables, t


def ulps(a, b) -> str:
    """The gap of two float32 arrays in units of the spacing at the larger
    magnitude of each pair."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    u = np.abs(a.astype(np.float64) - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return f"max {u.max():11.1f}  median {np.median(u):6.2f}  differ {np.mean(a != b):.3f}"


def nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def main():
    cfg = dataclasses.replace(load_config(DEFAULT_CONFIG), dtype=torch.float32)
    jmodel, *_ = build_jax(JaxConfig(shared_sampling_locations=True, decoder_sampling_groups=0))
    variables = random_variables(jax_variable_shapes(jmodel, canvas=(64, 64)), seed=20)
    tmodel, _ = build_salience_detr(cfg, torch.device("cpu"))
    tmodel.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    (H, W) = CANVAS
    images = np.random.default_rng(21).normal(size=(2, H, W, 3)).astype(np.float32)
    sizes = np.asarray([[H, W], list(PADDED)], np.int32)

    _, state = jax.jit(lambda v, x, s: jmodel.apply(v, x, s, train=False, capture_intermediates=True,
                                                    mutable=["intermediates"]))(
        variables, jnp.asarray(images), jnp.asarray(sizes))
    J = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(
        state["intermediates"])[0]}

    names = {m: n for n, m in tmodel.named_modules()}
    port = []

    def keep(module, inputs, output):
        outs = output if isinstance(output, (tuple, list)) else (output,)
        port.append((names[module], [o.numpy().copy() for o in outs if isinstance(o, torch.Tensor)],
                     inputs[0].numpy().copy() if inputs and isinstance(inputs[0], torch.Tensor) else None))

    hooks = [m.register_forward_hook(keep) for m in tmodel.modules()]
    with torch.no_grad():
        tmodel(t(images).permute(0, 3, 1, 2).contiguous(), t(sizes).long())
    for h in hooks:
        h.remove()

    def out(name, call=0, index=0):
        return [o for n, o, _ in port if n == name][call][index]

    def jx(path, call=0):
        return J[f"{path}['__call__'][{call}]"]

    print("module outputs, port against JAX (float32 ulps):")
    rows = [("backbone.conv1", nhwc(out("backbone.conv1")), jx("['backbone']['conv1']")),
            ("backbone.bn1", nhwc(out("backbone.bn1")), jx("['backbone']['bn1']")),
            ("backbone.layer1.0.conv1", nhwc(out("backbone.layer1.0.conv1")),
             jx("['backbone']['layer1_0']['conv1']")),
            ("backbone.layer1.0.conv2", nhwc(out("backbone.layer1.0.conv2")),
             jx("['backbone']['layer1_0']['conv2']"))]
    rows += [(f"backbone.layer{s}", nhwc(out(f"backbone.layer{s}")), jx(f"['backbone']['layer{s}_{n - 1}']"))
             for s, n in ((1, 3), (2, 4), (3, 6), (4, 3))]
    rows += [(f"neck (ChannelMapper) level {lvl}", nhwc(out("neck", 0, lvl)), J[f"['neck']['__call__'][0][{lvl}]"])
             for lvl in range(4)]
    rows += [(f"transformer.enc_output_norm call {c}", out("transformer.enc_output_norm", c),
              jx("['transformer']['enc_output_norm']", c)) for c in range(2)]
    rows += [(f"transformer.enc_mask_predictor level {3 - c}", out("transformer.enc_mask_predictor", c),
              jx("['transformer']['enc_mask_predictor']", c)) for c in range(4)]
    rows += [(f"transformer.encoder.layers.{i}", out(f"transformer.encoder.layers.{i}"),
              jx(f"['transformer']['encoder_layer_{i}']")) for i in range(6)]
    head_p, head_j = out("transformer.encoder_class_head", 6), jx("['transformer']['encoder_class_head']", 6)
    rows += [("transformer.encoder_class_head (proposals)", head_p, head_j),
             ("its max over classes (the top-k score)", head_p.max(-1), head_j.max(-1))]
    for name, a, b in rows:
        print(f"  {name:44s} {ulps(a, b)}")

    print("each module alone on the JAX package's input to it (what its own arithmetic adds):")
    bb, tr = tmodel.backbone, tmodel.transformer
    alone = [
        ("backbone.bn1 (FrozenBatchNorm2d)", bb.bn1, jx("['backbone']['conv1']"), jx("['backbone']['bn1']")),
        ("backbone.layer1.0.conv2 (3x3 conv)", bb.layer1[0].conv2,
         np.maximum(jx("['backbone']['layer1_0']['bn1']"), 0), jx("['backbone']['layer1_0']['conv2']")),
        ("backbone.layer1.0.conv3 (1x1 conv)", bb.layer1[0].conv3,
         np.maximum(jx("['backbone']['layer1_0']['bn2']"), 0), jx("['backbone']['layer1_0']['conv3']")),
        ("transformer.enc_output_norm (LayerNorm)", tr.enc_output_norm, jx("['transformer']['enc_output']", 1),
         jx("['transformer']['enc_output_norm']", 1)),
        ("transformer.encoder_class_head (Linear)", tr.encoder_class_head,
         jx("['transformer']['enc_output_norm']", 1), head_j),
    ]
    with torch.no_grad():
        for name, module, x, want in alone:
            if x.ndim == 4:
                got = nhwc(module(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy())
            else:
                got = module(torch.from_numpy(np.array(x))).numpy()
            print(f"  {name:44s} {ulps(got, want)}")

    v = variables["params"]["transformer"]["encoder_class_head"]
    kernel, bias = np.asarray(v["kernel"], np.float64), np.asarray(v["bias"], np.float64)
    x_port = [i for n, _, i in port if n == "transformer.encoder_class_head"][6]
    x_jax = jx("['transformer']['enc_output_norm']", 1)
    f_port, f_jax = x_port.astype(np.float64) @ kernel + bias, x_jax.astype(np.float64) @ kernel + bias
    print("encoder_class_head in float64 on each side's float32 input:")
    print(f"  {'its inputs, port against JAX':44s} {ulps(x_port, x_jax)}")
    print(f"  {'port float32 against float64(port input)':44s} {ulps(head_p, f_port)}")
    print(f"  {'JAX float32 against float64(JAX input)':44s} {ulps(head_j, f_jax)}")
    print(f"  {'float64(port input) against float64(JAX in)':44s} {ulps(f_port, f_jax)}")


if __name__ == "__main__":
    main()
