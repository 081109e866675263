"""Gradient accumulation in the port's train step against the JAX
package's (``accumulate_steps=2``): one step of the tiny config from an
exported init on a batch of 2 images of the written split, so micro-batches
of one image, as it is and with the second image's gts dropped so that the
second micro-batch has none (num_boxes clamped to 1, no CDN queries).  Each
micro-batch is normalized by its own gt count and gets the CDN draws the JAX
step made for it; the neck's BatchNorm statistics carry
from one micro-batch to the next; the averaged losses, ``grad_norm`` and the
updated parameters and statistics agree as in
tests/test_torch_port_train_pair.py.  A batch that does not divide raises in
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_torch.parallel.train_step import split_batch
from salience_detr_torch.train import synthetic_batch
from tests.test_torch_port_train_pair import JaxSide, check_metrics, check_states, run_pair
from tests.torch_port_common import CANVAS, jax_variable_shapes, random_variables, tiny_configs
from tests.torch_port_common import two_torch_threads  # noqa: F401

pytest.importorskip("cv2")  # the JAX dataset decodes and resizes with cv2


def drop_second_image_gts(batch):
    batch = dict(batch)
    batch["gt_valid"] = batch["gt_valid"].copy()
    batch["gt_valid"][1:] = False
    return batch


@pytest.fixture(scope="module", params=[None, drop_second_image_gts], ids=["as_loaded", "empty_second"])
def accumulated(request, tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("accum"), seed=1, steps=1, accumulate_steps=2,
                    edit_batch=request.param, batch=2)


def test_accumulated_step_losses_and_grad_norm(accumulated):
    jax_metrics, port_metrics, *_ = accumulated
    check_metrics(jax_metrics, port_metrics)


def test_accumulated_step_parameters_and_statistics(accumulated):
    _, _, init, jax_state, port_state = accumulated
    assert check_states(init, jax_state, port_state) > 500
    stats = [n for n in jax_state if ".neck." in n and n.endswith("running_mean")]
    assert stats and all(not torch.equal(jax_state[n], init[n]) for n in stats)


def test_split_batch_keeps_host_counts_and_raises_when_not_divisible():
    rng = np.random.default_rng(0)
    batch = synthetic_batch(rng, 5, (3, 0, 2, 4), CANVAS, 6, "cpu")
    parts = split_batch(batch, 2)
    assert [p["targets"].counts for p in parts] == [(3, 0), (2, 4)]
    torch.testing.assert_close(torch.cat([p["images"] for p in parts]), batch["images"])
    torch.testing.assert_close(torch.cat([p["targets"].valid for p in parts]), batch["targets"].valid)
    with pytest.raises(ValueError, match="not divisible by --accumulate-steps 3"):
        split_batch(batch, 3)


def test_jax_step_raises_when_not_divisible():
    jcfg, _ = tiny_configs()
    from salience_detr_tpu.models.factory import build_salience_detr as build_jax

    jmodel, *_ = build_jax(jcfg)
    variables = random_variables(jax_variable_shapes(jmodel), seed=0)
    side = JaxSide(jcfg, variables, 1, accumulate_steps=2)
    batch = {"images": np.zeros((3, *CANVAS, 3), np.uint8), "image_sizes": np.full((3, 2), 32, np.int32),
             "boxes": np.full((3, 2, 4), 0.5, np.float32), "labels": np.zeros((3, 2), np.int32),
             "gt_valid": np.zeros((3, 2), bool)}
    with pytest.raises(ValueError, match="not divisible by --accumulate-steps 2"):
        side.step(batch, 0)
    assert jax.device_get(side.state.step) == 0 and jnp is not None
