"""Port MSDA vs the JAX package: the plain version against the head-shared
(G=1), exact per-head (G=H) and grouped cores and the numpy spec, the
sampling-location helper, the MSDA module with weights carried through the
weight converter, and the kernel wrapper's CPU dispatch.  float32, atol 1e-5
(the cores' own differential tolerance) and rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks.attention import (
    MultiScaleDeformableAttention as JaxMSDA,
)
from salience_detr_tpu.ops.deform_attn import (
    compute_sampling_locations as jax_locations,
    deform_attn_numpy_spec,
    ms_deform_attn_core,
    ms_deform_attn_core_grouped,
    ms_deform_attn_core_quad,
    ms_deform_attn_core_shared,
)
from salience_detr_tpu.utils.weight_converter import (
    _msdeform,
    flat_to_nested,
    flatten_variables,
)
from salience_detr_torch import native
from salience_detr_torch.models.bricks.attention import MultiScaleDeformableAttention
from salience_detr_torch.ops.deform_attn import (
    compute_sampling_locations,
    ms_deform_attn,
    ms_deform_attn_plain,
)
from tests.torch_port_common import export_subtree, sane_random, t

RTOL, ATOL = 1e-3, 1e-5

# level sets: a regular pyramid, and one with single-row / single-column /
# single-pixel levels where every corner but one lies outside
LEVELS = {
    "pyramid": [(8, 12), (4, 6), (2, 3), (1, 2)],
    "thin": [(1, 7), (5, 1), (1, 1), (3, 2)],
}


def make_inputs(seed, levels, B=2, Q=7, G=1, H=4, D=4, P=3, loc_range=(-0.3, 1.3)):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in levels)
    value = rng.normal(size=(B, S, H * D)).astype(np.float32)
    locs = rng.uniform(*loc_range, size=(B, Q, G, len(levels), P, 2)).astype(np.float32)
    # points exactly on pixel centres and on the level borders
    locs[:, 0, :, :, 0] = 0.0
    locs[:, 1, :, :, 0] = 1.0
    w = rng.uniform(size=(B, Q, H, len(levels), P)).astype(np.float32)
    w = w / w.sum(axis=(-2, -1), keepdims=True)
    return value, locs, w


@pytest.mark.parametrize("levels", sorted(LEVELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_vs_shared_core_g1(levels, seed):
    lv = LEVELS[levels]
    value, locs, w = make_inputs(seed, lv, G=1)
    want = ms_deform_attn_core_shared(jnp.asarray(value), lv, jnp.asarray(locs[:, :, 0]), jnp.asarray(w), 4)
    got = ms_deform_attn_plain(t(value), lv, t(locs), t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("levels", sorted(LEVELS))
@pytest.mark.parametrize("core", ["quad", "gather"])
def test_plain_vs_exact_cores_gh(levels, core):
    lv = LEVELS[levels]
    value, locs, w = make_inputs(2, lv, G=4)
    fn = ms_deform_attn_core_quad if core == "quad" else ms_deform_attn_core
    B, S, C = value.shape
    want = fn(jnp.asarray(value.reshape(B, S, 4, C // 4)), lv, jnp.asarray(locs), jnp.asarray(w))
    got = ms_deform_attn_plain(t(value), lv, t(locs), t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("G", [1, 4])
def test_plain_vs_numpy_spec(G):
    lv = LEVELS["pyramid"]
    value, locs, w = make_inputs(3, lv, G=G, loc_range=(-0.6, 1.6))
    B, S, C = value.shape
    per_head = np.repeat(locs, 4 // G, axis=2)
    want = deform_attn_numpy_spec(value.reshape(B, S, 4, C // 4), lv, per_head, w)
    got = ms_deform_attn_plain(t(value), lv, t(locs), t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_vs_grouped_core_g2():
    lv = LEVELS["pyramid"]
    value, locs, w = make_inputs(4, lv, G=2)
    want = ms_deform_attn_core_grouped(jnp.asarray(value), lv, jnp.asarray(locs), jnp.asarray(w), 4)
    got = ms_deform_attn_plain(t(value), lv, t(locs), t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_points_far_outside_give_zero():
    lv = LEVELS["pyramid"]
    value, locs, w = make_inputs(5, lv, G=1)
    far = np.where(np.arange(locs.shape[1])[None, :, None, None, None, None] % 2, 7.5, -3.0)
    got = ms_deform_attn_plain(t(value), lv, t(np.broadcast_to(far, locs.shape).astype(np.float32)), t(w))
    assert got.abs().max().item() == 0.0


def test_cpu_wrapper_runs_plain_version():
    lv = LEVELS["pyramid"]
    value, locs, w = make_inputs(6, lv, G=1)
    before = dict(native.LAUNCHES)
    got = ms_deform_attn(t(value), lv, t(locs), t(w))
    torch.testing.assert_close(got, ms_deform_attn_plain(t(value), lv, t(locs), t(w)), rtol=0, atol=0)
    assert native.LAUNCHES == before


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_compute_sampling_locations(ref_dim):
    rng = np.random.default_rng(7)
    lv = LEVELS["pyramid"]
    ref = rng.uniform(size=(2, 5, len(lv), ref_dim)).astype(np.float32)
    off = rng.normal(size=(2, 5, 3, len(lv), 4, 2)).astype(np.float32)
    want = jax_locations(jnp.asarray(ref), jnp.asarray(off), lv, 4)
    got = compute_sampling_locations(t(ref), t(off), lv, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("G,ref_dim", [(1, 2), (4, 4)])
def test_msda_module_parity(G, ref_dim):
    """The flagship's encoder mode (G=1, point references) and decoder mode
    (G=H, box references), weights exported through the converter rules."""
    C, H, P = 16, 4, 3
    lv = LEVELS["pyramid"]
    L, S, B, Q = len(lv), sum(h * w for h, w in lv), 2, 6
    jmod = JaxMSDA(C, L, H, P, shared_locations=G == 1, sampling_groups=G)
    rng = np.random.default_rng(8)
    query = rng.normal(size=(B, Q, C)).astype(np.float32)
    value = rng.normal(size=(B, S, C)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, size=(B, Q, L, ref_dim)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[1, -9:] = True
    shapes = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(query), jnp.asarray(ref),
                          jnp.asarray(value), lv, jnp.asarray(mask))
    )
    flat = sane_random({k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}, seed=9)
    params = flat_to_nested(flat)
    want = jmod.apply(params, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(value), lv,
                      jnp.asarray(mask))

    tmod = MultiScaleDeformableAttention(C, L, H, P, sampling_groups=G)
    sd = export_subtree({"params": {"m": params["params"]}}, _msdeform("m", "m"), "m.")
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tmod(t(query), t(ref), t(value), lv, t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

