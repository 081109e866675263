"""The port's Grad-CAM (``salience_detr_torch.tools.grad_cam.make_cam_fn``)
against the JAX tool's (``tools/grad_cam.make_cam_fn``, run as that tool
runs, on the CPU) on the tiny hybrid model with bridged weights, two images,
one padded: the last decoder layer's logits and boxes at rtol 1e-3 / atol
1e-3 (the full-model tolerance) and each image's CAM within 1e-3 of its
largest value, as the one-step gradients of the paired train tests are
held (their 1e-6 floor is below the CAM's own scale here), at two neck
levels.  The random weights (``tests.torch_port_common.random_variables``)
give the sampling offsets nonzero weights, so the sampling points sit off
the pixel centres, where the bilinear weights have kinks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_torch.models.factory import build_salience_detr
from salience_detr_torch.tools.grad_cam import make_cam_fn
from salience_detr_torch.weights import state_dict_from_jax
from tests.torch_port_common import (
    CANVAS,
    build_jax_tiny,
    jax_variable_shapes,
    random_variables,
    t,
    two_torch_threads,  # noqa: F401
)
from tools import grad_cam as jax_grad_cam

TOP_K = 5


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg, jmodel = build_jax_tiny()
    variables = random_variables(jax_variable_shapes(jmodel), seed=7)
    model, _ = build_salience_detr(tcfg, torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
    rng = np.random.default_rng(8)
    images = rng.normal(size=(2, *CANVAS, 3)).astype(np.float32)
    sizes = np.asarray([list(CANVAS), [70, 101]], np.int32)
    return jmodel, variables, model, images, sizes


@pytest.mark.parametrize("level", [1, 2])
def test_grad_cam_matches_the_jax_tool(tiny, level):
    jmodel, variables, model, images, sizes = tiny
    want_cam, want_logits, want_coords = jax_grad_cam.make_cam_fn(jmodel, variables, level, TOP_K)(
        jnp.asarray(images), jnp.asarray(sizes))
    cam, logits, coords = make_cam_fn(model, level, TOP_K)(t(images).permute(0, 3, 1, 2).contiguous(),
                                                          t(sizes).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(coords.numpy(), np.asarray(want_coords), rtol=1e-3, atol=1e-3)
    want_cam = np.asarray(want_cam)
    assert cam.shape == want_cam.shape and cam.dtype == torch.float32
    for b in range(len(images)):
        scale = np.abs(want_cam[b]).max()
        assert scale > 0 and (want_cam[b] > 0).any()
        assert np.abs(cam[b].numpy() - want_cam[b]).max() <= 1e-3 * scale, (b, scale)
