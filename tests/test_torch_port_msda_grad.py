"""The port's MSDA backward against the JAX package: the plain backward
(``ms_deform_attn_backward_plain``, the spec of the backward kernel) against
``jax.vjp`` of the head-shared core with its quad-scatter custom VJP (G=1)
and of the exact per-head core (G=H), and against autograd of the port's
plain forward; the differentiable wrapper's CPU path against both.  float32,
rtol 1e-4, atol 1e-5.  Sampling points are drawn away from integer pixel
positions, where the bilinear weights' derivative jumps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.ops.deform_attn import ms_deform_attn_core, ms_deform_attn_core_shared
from salience_detr_torch import native
from salience_detr_torch.ops.deform_attn import (
    ms_deform_attn,
    ms_deform_attn_backward_plain,
    ms_deform_attn_plain,
)
from tests.torch_port_common import t

RTOL, ATOL = 1e-4, 1e-5
LEVELS = {
    "pyramid": [(8, 12), (4, 6), (2, 3), (1, 2)],
    "thin": [(1, 7), (5, 1), (1, 1), (3, 2)],
}


def away_from_pixels(locs, levels, margin=0.05):
    """Move each coordinate whose pixel position x * size - 0.5 lies within
    ``margin`` of an integer by 0.2 pixels."""
    locs = locs.copy()
    for lvl, (h, w) in enumerate(levels):
        for axis, size in ((0, w), (1, h)):
            view = locs[..., lvl, :, axis]
            frac = (view * size - 0.5) % 1.0
            near = (frac < margin) | (frac > 1.0 - margin)
            view[near] += 0.2 / size
    return locs


def make_inputs(seed, levels, B=2, Q=9, G=1, H=4, D=4, P=3):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in levels)
    value = rng.normal(size=(B, S, H * D)).astype(np.float32)
    locs = rng.uniform(-0.3, 1.3, size=(B, Q, G, len(levels), P, 2)).astype(np.float32)
    locs = away_from_pixels(locs, levels)
    w = rng.uniform(size=(B, Q, H, len(levels), P)).astype(np.float32)
    w = w / w.sum(axis=(-2, -1), keepdims=True)
    d_out = rng.normal(size=(B, Q, H * D)).astype(np.float32)
    return value, locs, w, d_out


def jax_vjp(G, levels, value, locs, w, d_out):
    """(d_value, d_locations (B, Q, G, L, P, 2), d_weights) from the JAX core."""
    B, S, C = value.shape
    H = w.shape[2]
    if G == 1:
        def f(v, loc, a):
            return ms_deform_attn_core_shared(v, levels, loc, a, H, quad_scatter=True)
        args = (value, locs[:, :, 0], w)
    else:
        def f(v, loc, a):
            return ms_deform_attn_core(v.reshape(B, S, H, C // H), levels, loc, a)
        args = (value, locs, w)
    _, vjp = jax.vjp(f, *map(jnp.asarray, args))
    dv, dl, dw = (np.asarray(x) for x in vjp(jnp.asarray(d_out)))
    return dv, dl.reshape(locs.shape), dw


@pytest.mark.parametrize("levels", sorted(LEVELS))
@pytest.mark.parametrize("G", [1, 4])
def test_plain_backward_vs_jax_vjp(levels, G):
    lv = LEVELS[levels]
    value, locs, w, d_out = make_inputs(10 + G, lv, G=G)
    want = jax_vjp(G, lv, value, locs, w, d_out)
    got = ms_deform_attn_backward_plain(t(value), lv, t(locs), t(w), t(d_out))
    for name, g, x in zip(("d_value", "d_locations", "d_weights"), got, want):
        np.testing.assert_allclose(g.numpy(), x, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_backward_vs_autograd_of_plain_forward(G):
    lv = LEVELS["pyramid"]
    value, locs, w, d_out = make_inputs(20 + G, lv, G=G)
    inputs = [t(x).requires_grad_() for x in (value, locs, w)]
    ms_deform_attn_plain(inputs[0], lv, inputs[1], inputs[2]).backward(t(d_out))
    got = ms_deform_attn_backward_plain(t(value), lv, t(locs), t(w), t(d_out))
    for name, g, x in zip(("d_value", "d_locations", "d_weights"), got, inputs):
        torch.testing.assert_close(g, x.grad, rtol=RTOL, atol=ATOL, msg=name)


def test_wrapper_is_differentiable_on_cpu():
    """The wrapper carries gradients to all three inputs (on CPU through the
    plain backward), with no kernel launch."""
    lv = LEVELS["thin"]
    value, locs, w, d_out = make_inputs(30, lv, G=1)
    inputs = [t(x).requires_grad_() for x in (value, locs, w)]
    before = dict(native.LAUNCHES)
    out = ms_deform_attn(inputs[0], lv, inputs[1], inputs[2])
    assert out.grad_fn is not None
    out.backward(t(d_out))
    assert native.LAUNCHES == before
    want = ms_deform_attn_backward_plain(t(value), lv, t(locs), t(w), t(d_out))
    for name, x, g in zip(("d_value", "d_locations", "d_weights"), inputs, want):
        torch.testing.assert_close(x.grad, g, rtol=0, atol=0, msg=name)


def test_wrapper_gradient_only_where_asked():
    lv = LEVELS["pyramid"]
    value, locs, w, d_out = make_inputs(31, lv, G=1)
    v = t(value).requires_grad_()
    ms_deform_attn(v, lv, t(locs), t(w)).backward(t(d_out))
    want = ms_deform_attn_backward_plain(t(value), lv, t(locs), t(w), t(d_out))[0]
    torch.testing.assert_close(v.grad, want, rtol=0, atol=0)


def test_points_outside_every_level_get_zero_gradient():
    lv = LEVELS["pyramid"]
    value, locs, w, d_out = make_inputs(32, lv, G=1)
    far = np.where(np.arange(locs.shape[1])[None, :, None, None, None, None] % 2, 7.5, -3.0)
    locs = np.broadcast_to(far, locs.shape).astype(np.float32)
    got = ms_deform_attn_backward_plain(t(value), lv, t(locs), t(w), t(d_out))
    assert all(float(g.abs().max()) == 0.0 for g in got)
