"""The port's greedy NMS keep mask and ``PostProcess`` against the JAX
package's, on the CPU.

``nms_keep_mask_plain`` must equal the JAX ``nms_keep_mask`` (vmapped over
the batch, as the JAX ``PostProcess`` calls it) exactly, and the naive
sequential greedy rule, on random boxes, a chain as deep as the boxes, all
boxes identical, IoUs exactly at the threshold in float32, and one box.
``PostProcess`` must give the JAX one's scores, labels and ``valid`` exactly
and its boxes within rtol 1e-6, with the filters off, one at a time, and
both on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks.post_process import PostProcess as JaxPostProcess
from salience_detr_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from salience_detr_torch import native
from salience_detr_torch.models.bricks.post_process import PostProcess
from salience_detr_torch.ops.boxes import box_iou_pairwise
from salience_detr_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain
from tests.test_torch_port_kernels import NMS_KEEP_CASES


CASES = NMS_KEEP_CASES


def jax_keep(boxes, thr):
    return np.asarray(jax.vmap(lambda b: jax_nms_keep_mask(b, thr))(jnp.asarray(boxes)))


def greedy_keep(boxes, thr):
    """The sequential rule itself: walk the ranks, keep a box unless a kept
    better-ranked one overlaps it above the threshold."""
    iou = box_iou_pairwise(torch.from_numpy(boxes), torch.from_numpy(boxes))[0].numpy()
    keep = np.zeros(boxes.shape[:2], bool)
    for b in range(boxes.shape[0]):
        for i in range(boxes.shape[1]):
            keep[b, i] = not (keep[b, :i] & (iou[b, i, :i] > np.float32(thr))).any()
    return keep


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_keep_mask_matches_jax(name):
    boxes, thr = CASES[name]
    got = nms_keep_mask_plain(torch.from_numpy(boxes), thr)
    assert got.dtype == torch.bool and got.shape == boxes.shape[:2]
    np.testing.assert_array_equal(got.numpy(), jax_keep(boxes, thr))
    np.testing.assert_array_equal(got.numpy(), greedy_keep(boxes, thr))


def test_cases_reach_their_edges():
    """The chain keeps every other box, identical boxes keep only the first,
    and the tie case holds IoUs equal to the threshold in float32 (which do
    not suppress)."""
    keep = nms_keep_mask_plain(torch.from_numpy(CASES["chain"][0]), 0.5)[0].numpy()
    np.testing.assert_array_equal(keep, np.arange(300) % 2 == 0)
    keep = nms_keep_mask_plain(torch.from_numpy(CASES["identical"][0]), 0.7).numpy()
    assert keep.sum(1).tolist() == [1, 1] and keep[:, 0].all()
    boxes, thr = CASES["ties"]
    iou = box_iou_pairwise(torch.from_numpy(boxes), torch.from_numpy(boxes))[0]
    off_diagonal = ~torch.eye(boxes.shape[1], dtype=torch.bool)
    assert int(((iou == thr) & off_diagonal).sum()) > 100


def test_cpu_wrapper_runs_plain_version():
    boxes, thr = CASES["random_0.5"]
    before = dict(native.LAUNCHES)
    got = nms_keep_mask(torch.from_numpy(boxes), thr)
    torch.testing.assert_close(got, nms_keep_mask_plain(torch.from_numpy(boxes), thr), rtol=0, atol=0)
    assert native.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no kernel"):
        nms_keep_mask(torch.empty(1, 3, 4, device="meta"), thr)


def post_inputs(seed=0, B=2, Q=60, C=5):
    """Logits, cxcywh boxes (a few queries share one box) and image sizes."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, Q, C)) * 2).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)), rng.uniform(0.05, 0.5, (B, Q, 2))], -1)
    boxes[:, 1::7] = boxes[:, ::7][:, : boxes[:, 1::7].shape[1]]
    sizes = np.asarray([[480, 640], [333, 517]][:B], np.int32)
    return logits, boxes.astype(np.float32), sizes


# (nms_iou_threshold, confidence_score): off, confidence only, NMS only, both
FILTERS = [(-1.0, -1.0), (-1.0, 0.9), (0.5, -1.0), (0.7, 0.9)]


@pytest.mark.parametrize("nms,conf", FILTERS)
def test_postprocess_matches_jax(nms, conf):
    logits, boxes, sizes = post_inputs()
    want = jax.device_get(JaxPostProcess(50, nms, conf)(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(sizes)))
    got = PostProcess(50, nms, conf)(torch.from_numpy(logits), torch.from_numpy(boxes), torch.from_numpy(sizes))
    assert set(got) == set(want) == {"scores", "labels", "boxes", "valid"}
    for key in ("scores", "labels", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=1e-6, atol=0)
    n_valid = int(got["valid"].sum())
    if (nms, conf) == (-1.0, -1.0):
        assert n_valid == got["valid"].numel()
    else:
        assert 0 < n_valid < got["valid"].numel()  # the filter removed some, not all
