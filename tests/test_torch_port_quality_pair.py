"""The longer paired curve: 12 steps of the JAX ``make_train_step`` beside 12
steps of the port's on the rectangles split of the quality tools, at one
batch size.

The JAX tool's generator (``tools/validate_static_shapes.make_dataset``)
writes its JPEGs and the port's (``salience_detr_torch/tools/synthetic``)
its ``.npy`` files from the same seed; each package's train loader reads its
own files with the ``hflip`` preset on the 128x128 canvas, and their batches
are held equal.  From one exported init, each port step is fed the CDN draws
the JAX step made; per step every weighted loss, the total and ``grad_norm``
agree at rtol 1e-3 / atol 1e-4 (float32), as in
tests/test_torch_port_train_pair.py, whose two sides this file reuses."""

import numpy as np
import pytest
import torch

from salience_detr_tpu.data import coco as jcoco
from salience_detr_tpu.data import loader as jloader
from salience_detr_tpu.data import transforms as jt
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_torch.data import coco as pcoco
from salience_detr_torch.data import loader as ploader
from salience_detr_torch.data import transforms as pt
from salience_detr_torch.tools import synthetic
from tests.test_torch_port_train import torch_draws
from tests.test_torch_port_train_pair import JaxSide, PortSide, check_metrics
from tests.torch_port_common import jax_variable_shapes, random_variables, tiny_configs
from tests.torch_port_common import two_torch_threads  # noqa: F401

pytest.importorskip("cv2")  # the JAX generator writes and its dataset decodes JPEGs with cv2

STEPS, BATCH, MAX_GT, SEED = 12, 2, 8, 0


@pytest.fixture(scope="module")
def curve(tmp_path_factory):
    from tools.validate_static_shapes import make_dataset as jax_make_dataset

    root = tmp_path_factory.mktemp("curve")
    n = STEPS * BATCH
    jax_img, jax_ann = jax_make_dataset(str(root / "jax"), n, SEED)
    port_img, port_ann = synthetic.make_dataset(str(root / "port"), n, SEED)
    kw = dict(canvas_hw=synthetic.CANVAS, max_gt=MAX_GT, shuffle=True, seed=SEED, num_workers=2, drop_last=True)
    jax_batches = list(jloader.DetectionLoader(
        jcoco.CocoDetection(jax_img, jax_ann, transforms=jt.PRESETS["hflip"], train=True), BATCH, **kw))
    port_loader = ploader.TrainLoader(
        pcoco.CocoDetection(port_img, port_ann, transforms=pt.build_preset("hflip"), train=True), BATCH, **kw)
    port_batches = list(port_loader)
    assert len(jax_batches) == len(port_batches) == STEPS
    for w, g in zip(jax_batches, port_batches):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)

    jcfg, tcfg = tiny_configs()
    jmodel, *_ = build_jax(jcfg)
    variables = random_variables(jax_variable_shapes(jmodel), seed=SEED)
    jside = JaxSide(jcfg, variables, len(port_loader), 1)
    pside = PortSide(tcfg, variables, len(port_loader), 1)
    jax_metrics, port_metrics = [], []
    for i, (jb, pb) in enumerate(zip(jax_batches, port_batches)):
        jm = jside.step(jb, 100 + i)
        jm["grad_norm_trainable"] = jside.norms[-1]
        jax_metrics.append(jm)
        draws = [torch_draws(*d) for d in jside.draws[-1:]]
        pm = pside.step(ploader.train_to_device(pb, torch.device("cpu")), draws=draws)
        port_metrics.append({k: float(v) for k, v in pm.items()})
    return jax_metrics, port_metrics


def test_twelve_steps_losses_and_grad_norm(curve):
    jax_metrics, port_metrics = curve
    assert len(port_metrics) == STEPS
    check_metrics(jax_metrics, port_metrics)


def test_every_step_moves_the_loss(curve):
    """The batches and the weights change from step to step, and so does
    every step's loss, on both sides."""
    for metrics in curve:
        losses = [m["loss"] for m in metrics]
        assert len({round(v, 6) for v in losses}) == STEPS and np.isfinite(losses).all()
