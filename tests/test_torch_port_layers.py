"""Port layers vs the JAX package: a ResNet Bottleneck with FrozenBN, the
salience encoder layer in the flagship's head-shared mode (G=1), the
decoder layer in its exact per-head mode (G=H), and the neck's training
conv + BatchNorm at one image, its output gradient laid out as the token
slices give it.  Weights go through the
weight converter's rules; float32, rtol 1e-3 / atol 1e-5 (the block
tolerance of tests/test_torch_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.backbones.resnet import Bottleneck as JaxBottleneck
from salience_detr_tpu.models.bricks.salience_transformer import (
    SalienceDecoderLayer as JaxDecoderLayer,
    SalienceEncoderLayer as JaxEncoderLayer,
)
from salience_detr_tpu.models.necks.repnet import ConvBNAct as JaxConvBNAct
from salience_detr_tpu.utils.weight_converter import (
    _conv_bn_act,
    _resnet_rules,
    flat_to_nested,
    flatten_variables,
    salience_detr_head_rules,
)
from salience_detr_torch.models.backbones.resnet import Bottleneck
from salience_detr_torch.models.bricks.salience_transformer import (
    SalienceDecoderLayer,
    SalienceEncoderLayer,
)
from salience_detr_torch.models.necks.repnet import ConvBNAct
from tests.torch_port_common import export_subtree, sane_random, t

RTOL, ATOL = 1e-3, 1e-5
C, H, L, P, FFN, NCLS = 32, 4, 4, 4, 64, 5
LEVELS = [(8, 10), (4, 5), (2, 3), (1, 2)]
S = sum(h * w for h, w in LEVELS)


def random_tree(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    flat = flatten_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    return flat_to_nested(sane_random({k: v.shape for k, v in flat.items()}, seed))


def nest(tree, *path):
    """{collection: sub} -> {collection: {path[0]: {...: sub}}}."""
    out = {}
    for coll, sub in tree.items():
        for p in reversed(path):
            sub = {p: sub}
        out[coll] = sub
    return out


def test_bottleneck_frozen_bn():
    x = np.random.default_rng(0).normal(size=(2, 12, 10, 32)).astype(np.float32)
    jmod = JaxBottleneck(planes=16, stride=2, downsample=True)
    variables = random_tree(jmod, jnp.asarray(x), seed=1)
    want = jmod.apply(variables, jnp.asarray(x))

    tmod = Bottleneck(32, 16, stride=2, downsample=True)
    rules = _resnet_rules((3, 4, 6, 3), bottleneck=True)
    tmod.load_state_dict(
        export_subtree(nest(variables, "backbone", "layer2_0"), rules, "backbone.layer2.0."),
        strict=True,
    )
    with torch.no_grad():
        got = tmod(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["contiguous", "token_slice"])
def test_neck_conv_bn_gradient_at_one_image(layout):
    """At one image the gradient reaching a neck map is a slice of a
    (1, S, C) token gradient (channels-last strides, batch stride C);
    ``batch_norm``'s CPU backward misreads that layout, so the port's
    BatchNorm makes it contiguous.  Input and weight gradients equal flax's."""
    h, w, skip = 3, 4, 5
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, h, w, 16)).astype(np.float32) * 2 + 0.5
    gy = rng.normal(size=(1, h, w, C)).astype(np.float32)
    jmod = JaxConvBNAct(C, 3)
    variables = random_tree(jmod, jnp.asarray(x), seed=4)

    def f(params, xx):
        y, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, train=True,
                          mutable=["batch_stats"])
        return (y * gy).sum()

    want_p, want_x = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    tmod = ConvBNAct(16, C, 3)
    tmod.load_state_dict(export_subtree(nest(variables, "m"), _conv_bn_act("m", "m"), "m."), strict=False)
    tmod.train()
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    y = tmod(xt)
    g = t(gy).permute(0, 3, 1, 2).contiguous()
    if layout == "token_slice":
        tokens = torch.zeros(1, skip + h * w, C)
        tokens[0, skip:] = t(gy).reshape(h * w, C)
        g = tokens[:, skip:].transpose(1, 2).reshape(1, C, h, w)
        assert g.stride() == (C, 1, w * C, C) and torch.equal(g, t(gy).permute(0, 3, 1, 2))
    y.backward(g)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmod[0].weight.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(want_p["conv"]["kernel"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmod[1].bias.grad.numpy(), np.asarray(want_p["bn"]["bias"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_layer_head_shared(seed):
    rng = np.random.default_rng(seed)
    B, K = 2, 20
    query = rng.normal(size=(B, K, C)).astype(np.float32)
    pos = rng.normal(size=(B, K, C)).astype(np.float32)
    value = rng.normal(size=(B, S, C)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, size=(B, K, L, 2)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[1, 50:80] = True
    score = rng.normal(size=(B, K, NCLS)).astype(np.float32)
    score[:, 10:] = score[:, :1]  # tied pre-attention scores
    fg = np.ones((B, K), np.float32)
    args = [jnp.asarray(a) for a in (query, pos, value, ref)] + [LEVELS] + [
        jnp.asarray(a) for a in (mask, score, fg)
    ]
    jmod = JaxEncoderLayer(C, FFN, H, L, P, topk_sa=12, shared_locations=True)
    variables = random_tree(jmod, *args, seed=2 + seed)
    want = jmod.apply(variables, *args)

    tmod = SalienceEncoderLayer(C, FFN, H, L, P, topk_sa=12, sampling_groups=1)
    rules = salience_detr_head_rules(num_encoder_layers=1, num_decoder_layers=0)
    tmod.load_state_dict(
        export_subtree(nest(variables, "transformer", "encoder_layer_0"), rules,
                       "transformer.encoder.layers.0."),
        strict=True,
    )
    with torch.no_grad():
        got = tmod(t(query), t(pos), t(value), t(ref), LEVELS, t(mask), t(score), t(fg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_decoder_layer_exact_per_head():
    rng = np.random.default_rng(3)
    B, Q = 2, 9
    query = rng.normal(size=(B, Q, C)).astype(np.float32)
    pos = rng.normal(size=(B, Q, C)).astype(np.float32)
    ref = np.concatenate(
        [rng.uniform(0.1, 0.9, size=(B, Q, L, 2)), rng.uniform(0.05, 0.4, size=(B, Q, L, 2))], -1
    ).astype(np.float32)
    value = rng.normal(size=(B, S, C)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[0, 70:80] = True
    args = [jnp.asarray(query), jnp.asarray(pos), jnp.asarray(ref), jnp.asarray(value), LEVELS,
            jnp.asarray(mask)]
    jmod = JaxDecoderLayer(C, FFN, H, L, P, shared_locations=False, sampling_groups=H)
    variables = random_tree(jmod, *args, seed=4)
    want = jmod.apply(variables, *args)

    tmod = SalienceDecoderLayer(C, FFN, H, L, P, sampling_groups=H)
    rules = salience_detr_head_rules(num_encoder_layers=0, num_decoder_layers=1)
    tmod.load_state_dict(
        export_subtree(nest(variables, "transformer", "decoder_layer_0"), rules,
                       "transformer.decoder.layers.0."),
        strict=True,
    )
    with torch.no_grad():
        got = tmod(t(query), t(pos), t(ref), t(value), LEVELS, t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
