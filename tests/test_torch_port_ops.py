"""Port ops vs the JAX package (ops/misc.py, ops/pos_encoding.py,
ops/boxes.py, the stable top-k and the cascade resize): the same numpy inputs
through both, float32, rtol 1e-3 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks import salience_transformer as jax_st
from salience_detr_tpu.ops import boxes as jax_boxes
from salience_detr_tpu.ops import misc as jax_misc
from salience_detr_tpu.ops import pos_encoding as jax_pos
from salience_detr_torch.models.bricks.salience_transformer import bilinear_resize_align_corners
from salience_detr_torch.ops import boxes, misc, pos_encoding
from tests.torch_port_common import t

RTOL, ATOL = 1e-3, 1e-5
SHAPES = [(12, 16), (6, 8), (3, 4), (2, 2)]
CANVAS = (96, 128)


def close(got, want, **kw):
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want),
        rtol=kw.get("rtol", RTOL), atol=kw.get("atol", ATOL),
    )


def test_inverse_sigmoid():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, size=(5, 7)).astype(np.float32)
    x[0, :3] = [0.0, 1.0, 0.0005]
    close(misc.inverse_sigmoid(t(x)), jax_misc.inverse_sigmoid(jnp.asarray(x)))


def test_box_cxcywh_to_xyxy():
    x = np.random.default_rng(1).uniform(size=(3, 9, 4)).astype(np.float32)
    close(boxes.box_cxcywh_to_xyxy(t(x)), jax_boxes.box_cxcywh_to_xyxy(jnp.asarray(x)))


@pytest.mark.parametrize("sizes", [[[96, 128], [50, 70]], [[33, 128], [96, 1]]])
def test_masks_and_valid_ratios(sizes):
    sizes = np.asarray(sizes, np.int32)
    jv = jax_misc.multi_level_valid_sizes(jnp.asarray(sizes), CANVAS, SHAPES)
    tv = misc.multi_level_valid_sizes(torch.from_numpy(sizes).long(), CANVAS, SHAPES)
    for a, b, s in zip(tv, jv, SHAPES):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(misc.rect_mask(a, s).numpy(), np.asarray(jax_misc.rect_mask(b, s)))
    close(misc.valid_ratios(tv, SHAPES), jax_misc.valid_ratios(jv, SHAPES))


def test_flatten_multi_level():
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(2, h, w, 3)).astype(np.float32) for h, w in SHAPES]
    masks = [rng.uniform(size=(2, h, w)) > 0.5 for h, w in SHAPES]
    np.testing.assert_array_equal(
        misc.flatten_multi_level([t(f) for f in feats]).numpy(),
        np.asarray(jax_misc.flatten_multi_level([jnp.asarray(f) for f in feats])),
    )
    np.testing.assert_array_equal(
        misc.flatten_multi_level([t(m) for m in masks]).numpy(),
        np.asarray(jax_misc.flatten_multi_level([jnp.asarray(m) for m in masks])),
    )


def test_sine_position_embedding():
    valid = np.asarray([[12, 16], [7, 11]], np.int32)
    mask = np.asarray(jax_misc.rect_mask(jnp.asarray(valid), SHAPES[0]))
    want = jax_pos.sine_position_embedding(jnp.asarray(mask), 16, normalize=True, offset=-0.5)
    got = pos_encoding.sine_position_embedding(t(mask), 16, normalize=True, offset=-0.5)
    close(got, want)


def test_get_sine_pos_embed():
    x = np.random.default_rng(3).uniform(size=(2, 9, 4)).astype(np.float32)
    close(pos_encoding.get_sine_pos_embed(t(x), 16), jax_pos.get_sine_pos_embed(jnp.asarray(x), 16))


def test_stable_topk_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, size=(3, 40)).astype(np.float32)  # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 17)
    got_v, got_i = misc.stable_topk(t(x), 17)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # the global sort of the cascade: jnp.argsort of the negated scores
    np.testing.assert_array_equal(
        misc.stable_topk(t(x), 40)[1].numpy(), np.asarray(jnp.argsort(-jnp.asarray(x), axis=1))
    )


@pytest.mark.parametrize("src,dst", [((3, 4), (6, 8)), ((2, 2), (3, 4)), ((1, 5), (1, 9))])
def test_bilinear_resize_align_corners(src, dst):
    x = np.random.default_rng(5).normal(size=(2, *src, 1)).astype(np.float32)
    close(
        bilinear_resize_align_corners(t(x), dst),
        jax_st.bilinear_resize_align_corners(jnp.asarray(x), dst),
    )
