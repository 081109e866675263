"""The port's int8 head-shared MSDA (``MSDA_GATHER_QUANT=int8``) against the
JAX package's ``ms_deform_attn_core_shared_q8``, on the CPU (plain
versions), inputs from numpy seeds.

Checked: the plain version exactly equal to the JAX core in float32 on
lossless inputs (integer-valued channels with absmax 127, so the scale is 1;
power-of-two level sizes and dyadic pixel positions and weights, so every
product and sum is exact), including points outside and on the borders of
their levels and 1-wide levels; within rtol 1e-5 (atol 1e-6) of it on random
float32 inputs; within one bf16 ulp of it in bfloat16 (both round the same
operands; their f32 sums may differ in order); equal to it in float16, also
where the corner weights are float16 subnormals; the quantisation error bound
scale / 2 against the exact head-shared MSDA; the int8 table equal to the
JAX package's; and the module's routing: int8 in eval at G = 1 with the
switch set, equal to the JAX module under the same switch (rtol 1e-5),
never in training, at G > 1 or without the switch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks.attention import MultiScaleDeformableAttention as JaxMSDA
from salience_detr_tpu.ops.deform_attn import ms_deform_attn_core_shared_q8
from salience_detr_tpu.utils.weight_converter import _msdeform
from salience_detr_torch.models.bricks import attention
from salience_detr_torch.models.bricks.attention import MultiScaleDeformableAttention
from salience_detr_torch.ops.deform_attn import (
    ms_deform_attn_plain,
    ms_deform_attn_q8,
    ms_deform_attn_q8_plain,
    q8_quantize_plain,
)
from tests.torch_port_common import export_subtree, t

# power-of-two sides (exact loc * w), a 1-wide column and a 1x1 level
DYADIC_LEVELS = [(8, 16), (4, 8), (4, 1), (1, 1)]
LEVELS = [(10, 14), (5, 7), (3, 4), (1, 2)]


def jax_q8(value, levels, locs, w, H):
    return np.asarray(ms_deform_attn_core_shared_q8(jnp.asarray(value), levels, jnp.asarray(locs),
                                                    jnp.asarray(w), H))


def lossless_inputs(seed, B=2, Q=13, H=2, D=8, P=3, levels=DYADIC_LEVELS):
    """Integer values in [-127, 127] with every channel's absmax 127; pixel
    positions on a quarter-pixel grid from 2 pixels before to 2 after each
    level; weights multiples of 1/64."""
    rng = np.random.default_rng(seed)
    S, C, L = sum(h * w for h, w in levels), H * D, len(levels)
    value = rng.integers(-127, 128, size=(B, S, C)).astype(np.float32)
    value[0, 0] = 127.0
    locs = np.zeros((B, Q, L, P, 2), np.float32)
    for lvl, (h, w) in enumerate(levels):
        for axis, size in ((0, w), (1, h)):
            pixel = rng.integers(-8, 4 * size + 8, size=(B, Q, P)) / 4.0  # x = loc * size - 0.5
            locs[:, :, lvl, :, axis] = (pixel + 0.5) / size
    locs[0, 0] = -3.0  # every point outside
    w = rng.integers(1, 17, size=(B, Q, H, L, P)).astype(np.float32) / 64.0
    return value, locs, w


@pytest.mark.parametrize("seed,levels", [(0, DYADIC_LEVELS), (1, [(1, 8), (2, 2), (1, 1)])])
def test_plain_equals_jax_exactly_on_lossless_inputs(seed, levels):
    H = 2
    value, locs, w = lossless_inputs(seed, H=H, levels=levels)
    got = ms_deform_attn_q8_plain(t(value), levels, t(locs), t(w))
    np.testing.assert_array_equal(got.numpy(), jax_q8(value, levels, locs, w, H))
    table, scale = q8_quantize_plain(t(value))
    assert torch.equal(scale, torch.ones_like(scale)) and torch.equal(table.float(), t(value))
    # lossless: the exact head-shared MSDA gives the same
    exact = ms_deform_attn_plain(t(value), levels, t(locs)[:, :, None].contiguous(), t(w))
    np.testing.assert_array_equal(got.numpy(), exact.numpy())


def random_inputs(seed, B=2, Q=17, H=4, D=8, P=4, levels=LEVELS):
    rng = np.random.default_rng(seed)
    S, L = sum(h * w for h, w in levels), len(levels)
    value = rng.normal(size=(B, S, H * D)).astype(np.float32)
    locs = rng.uniform(-0.3, 1.3, size=(B, Q, L, P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    return value, locs, (w / w.sum(axis=(-2, -1), keepdims=True)).astype(np.float32)


def test_plain_matches_jax_on_random_inputs():
    value, locs, w = random_inputs(2)
    got = ms_deform_attn_q8_plain(t(value), LEVELS, t(locs), t(w))
    np.testing.assert_allclose(got.numpy(), jax_q8(value, LEVELS, locs, w, 4), rtol=1e-5, atol=1e-6)


def test_plain_matches_jax_in_bfloat16():
    value, locs, w = random_inputs(3)
    want = np.asarray(ms_deform_attn_core_shared_q8(
        jnp.asarray(value, jnp.bfloat16), LEVELS, jnp.asarray(locs), jnp.asarray(w, jnp.bfloat16), 4
    ).astype(jnp.float32))
    got = ms_deform_attn_q8_plain(t(value).bfloat16(), LEVELS, t(locs), t(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


def subnormal_corner_inputs(seed):
    """Random inputs whose points sit 2^-10 to 2^-9 of a pixel past a pixel
    centre on both axes, so that a corner weight wx * wy of about 1e-6 is
    a subnormal float16 (below 2^-14) where it is a normal bfloat16."""
    value, locs, w = random_inputs(seed)
    rng = np.random.default_rng(seed + 100)
    for lvl, (h, w_) in enumerate(LEVELS):
        for axis, size in ((0, w_), (1, h)):
            pixel = rng.integers(-1, size + 1, size=locs.shape[:2] + locs.shape[3:4])
            frac = rng.uniform(2.0 ** -10, 2.0 ** -9, size=pixel.shape)
            locs[:, :, lvl, :, axis] = (pixel + frac + 0.5) / size
    return value, locs, w


@pytest.mark.parametrize("case", ["random", "subnormal corner weights"])
def test_plain_matches_jax_in_float16(case):
    """ROADMAP C-29: the int8 core under a float16 model.  The JAX core
    reduces in the value's dtype (float16 here) and the plain version rounds
    the same operands to float16, subnormals included: equal bit for bit
    on these inputs."""
    value, locs, w = random_inputs(3) if case == "random" else subnormal_corner_inputs(5)
    if case != "random":
        x = locs[..., 0] * np.array([w_ for _, w_ in LEVELS], np.float32)[:, None] - 0.5
        y = locs[..., 1] * np.array([h for h, _ in LEVELS], np.float32)[:, None] - 0.5
        corner = (x - np.floor(x)) * (y - np.floor(y))
        assert ((corner > 0) & (corner < 2.0 ** -14)).mean() > 0.9
    want = np.asarray(ms_deform_attn_core_shared_q8(
        jnp.asarray(value, jnp.float16), LEVELS, jnp.asarray(locs), jnp.asarray(w, jnp.float16), 4
    ).astype(jnp.float32))
    got = ms_deform_attn_q8_plain(t(value).half(), LEVELS, t(locs), t(w).half())
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(ms_deform_attn_q8(t(value).half(), LEVELS, t(locs), t(w).half()), got)


def test_quantisation_matches_jax_and_its_error_bound():
    """The table equals the JAX package's quantisation (``round`` half to
    even, clip to 127); the output errs from the exact head-shared MSDA by
    at most scale / 2 per channel (corner weights sum to at most 1 per point,
    attention weights to 1 per head)."""
    value, locs, w = random_inputs(4)
    value[1, 3] = 0.0  # a zeroed padding row
    table, scale = q8_quantize_plain(t(value))
    jscale = np.maximum(np.abs(value).max(axis=(0, 1)) / np.float32(127.0), np.float32(1e-20))
    np.testing.assert_array_equal(scale.numpy(), jscale)
    jtable = np.asarray(jnp.clip(jnp.round(jnp.asarray(value) / jnp.asarray(jscale)), -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(table.numpy(), jtable)
    got = ms_deform_attn_q8_plain(t(value), LEVELS, t(locs), t(w))
    exact = ms_deform_attn_plain(t(value), LEVELS, t(locs)[:, :, None].contiguous(), t(w))
    err = (got - exact).abs().amax(dim=(0, 1))
    assert bool((err <= scale / 2 + 1e-6).all()), (err / scale).max()
    assert float((err / scale).max()) > 0.01  # the quantisation does act


def module_pair(G, seed=6, C=32, H=4, L=4, P=4):
    """The port's module and the JAX one with the same random weights."""
    rng = np.random.default_rng(seed)
    port = MultiScaleDeformableAttention(C, L, H, P, sampling_groups=G)
    jmod = JaxMSDA(C, L, H, P, sampling_groups=G)
    shapes = {"sampling_offsets": (C, G * L * P * 2), "attention_weights": (C, H * L * P),
              "value_proj": (C, C), "output_proj": (C, C)}
    params = {}
    for name, (fan_in, out) in shapes.items():
        params[name] = {"kernel": (rng.normal(size=(fan_in, out)) / np.sqrt(fan_in)).astype(np.float32),
                        "bias": (0.1 * rng.normal(size=(out,))).astype(np.float32)}
    variables = {"params": {"m": params}}
    port.load_state_dict(export_subtree(variables, _msdeform("m", "m"), "m."), strict=True)
    return port, jmod, {"params": params}


def module_inputs(seed=7, B=2, Q=9, C=32):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in LEVELS)
    query = rng.normal(size=(B, Q, C)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, size=(B, Q, len(LEVELS), 2)).astype(np.float32)
    value = rng.normal(size=(B, S, C)).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[1, -20:] = True
    return query, ref, value, pad


@pytest.mark.parametrize("case", ["eval G=1 int8", "train G=1 int8", "eval G=4 int8", "eval G=1 none"])
def test_module_routes_through_the_int8_core(case, monkeypatch):
    mode, groups, quant = case.split()
    G = int(groups[2:])
    monkeypatch.setenv("MSDA_GATHER_QUANT", quant)
    calls = []
    real = attention.ms_deform_attn_q8
    monkeypatch.setattr(attention, "ms_deform_attn_q8", lambda *a: calls.append(1) or real(*a))
    port, jmod, variables = module_pair(G)
    port.train(mode == "train")
    query, ref, value, pad = module_inputs()
    got = port(t(query), t(ref), t(value), LEVELS, t(pad))
    routed = mode == "eval" and G == 1 and quant == "int8"
    assert len(calls) == int(routed)
    # the JAX module reads the same switch at trace time
    want = jmod.apply(variables, *map(jnp.asarray, (query, ref, value)), LEVELS, jnp.asarray(pad),
                      train=mode == "train")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_wrapper_is_the_plain_version_on_the_cpu():
    value, locs, w = random_inputs(8)
    got = ms_deform_attn_q8(t(value), LEVELS, t(locs), t(w))
    assert torch.equal(got, ms_deform_attn_q8_plain(t(value), LEVELS, t(locs), t(w)))
