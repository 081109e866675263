"""The train slice as a whole against the JAX package: the tiny config of
tests/torch_port_common.py from one exported init, the same COCO-format
split through both train loaders (the ``detr`` preset, the landscape
canvas), and 3 steps of the JAX ``make_train_step`` beside 3 steps of the
port's, each port step fed the CDN draws the JAX step made, at 2 images a
batch and at one.  Per step every
weighted loss, the total and ``grad_norm`` agree at rtol 1e-3 / atol 1e-4
(float32); after the 3 steps every parameter and BatchNorm statistic agrees
as the one-step gradients of tests/test_torch_port_train.py do, relative to
the size of what 3 steps moved.

The JAX step's ``grad_norm`` metric also counts the frozen parameters'
gradients (ROADMAP C-15); the port's, like the clip of both, counts the
trainable ones only.  The JAX side here reads the norm the clip sees through
a probe chained in front of its optimizer."""

from typing import NamedTuple

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from salience_detr_tpu.data import coco as jcoco
from salience_detr_tpu.data import loader as jloader
from salience_detr_tpu.data import transforms as jt
from salience_detr_tpu.engine import optim as jax_optim
from salience_detr_tpu.models.backbones.resnet import frozen_param_predicate
from salience_detr_tpu.models.bricks import denoising as jax_dn  # noqa: F401 (tests/test_torch_port_ddp_step.py)
from salience_detr_tpu.models.bricks.criterion import default_weight_dict as jax_weight_dict
from salience_detr_tpu.models.detectors.salience_detr import normalize_images as jax_normalize
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.parallel.train_step import TrainState
from salience_detr_tpu.parallel.train_step import make_train_step as jax_make_train_step
from salience_detr_torch.data import coco as pcoco
from salience_detr_torch.data import loader as ploader
from salience_detr_torch.data import transforms as pt
from salience_detr_torch.engine.optim import build_optimizer, make_lr_schedule
from salience_detr_torch.models.bricks.criterion import default_weight_dict
from salience_detr_torch.models.factory import build_criteria, build_salience_detr
from salience_detr_torch.parallel.train_step import make_train_step
from salience_detr_torch.weights import state_dict_from_jax
from tests.test_torch_port_train import jax_cdn_draws, torch_draws
from tests.torch_port_common import CANVAS, jax_variable_shapes, random_variables, tiny_configs, write_coco_split
from tests.torch_port_common import two_torch_threads  # noqa: F401

pytest.importorskip("cv2")  # the JAX dataset decodes and resizes with cv2

RTOL, ATOL = 1e-3, 1e-4
LR, WD, BETAS, MAX_NORM = 1e-4, 1e-4, (0.9, 0.999), 0.1
SIZES = [(60, 80), (72, 96), (45, 97), (50, 70), (66, 88), (75, 100), (48, 64), (81, 120), (40, 50), (90, 120),
         (64, 86), (52, 70)]
COUNTS = [3, 9, 1, 6, 2, 5, 8, 4, 7, 1, 3, 2]
BATCH, MAX_GT = 2, 6


def load_batches(root, seed, count, batch=BATCH):
    """The first ``count`` landscape batches of ``batch`` images of epoch 0
    of both loaders, held equal; returns (JAX batches, port batches, steps
    per epoch)."""
    img_dir, ann = write_coco_split(root, SIZES, seed=seed, counts=COUNTS)
    kw = dict(canvas_hw=CANVAS, max_gt=MAX_GT, shuffle=True, seed=seed, num_workers=2, drop_last=True)
    jax_loader = jloader.DetectionLoader(
        jcoco.CocoDetection(str(img_dir), str(ann), transforms=jt.PRESETS["detr"], train=True), batch, **kw)
    port_loader = ploader.TrainLoader(
        pcoco.CocoDetection(str(img_dir), str(ann), transforms=pt.build_preset("detr"), train=True), batch, **kw)
    want, got = list(jax_loader), list(port_loader)
    for w, g in zip(want, got):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    pairs = [(w, g) for w, g in zip(want, got) if w["images"].shape[1:3] == CANVAS][:count]
    assert len(pairs) == count
    return [w for w, _ in pairs], [g for _, g in pairs], len(port_loader)


class NormProbeState(NamedTuple):
    norm: jnp.ndarray  # the trainable gradients' global norm at the last update


class RootDenoisingRng(fnn.Module):
    """The key ``make_rng("denoising")`` gives at the root scope of an apply,
    which is where the detector draws its CDN key: flax derives it from the
    apply's key, the scope path and the call count alone."""

    @fnn.compact
    def __call__(self):
        return self.make_rng("denoising")


class JaxSide:
    """The JAX train step from ``variables``, with each micro-batch's CDN
    draws and the trainable gradients' norm.  Neither leaves the compiled
    step through a host callback, so the persistent compilation cache keeps
    the step (ROADMAP C-31): the norm is the state of a probe chained in
    front of the optimizer, and the draws are made again outside the step
    from its key, split as ``make_train_step`` splits it (per micro-batch,
    then the denoising half of the model's keys)."""

    def __init__(self, jcfg, variables, steps_per_epoch, accumulate_steps):
        self.model, crit, sal, _ = build_jax(jcfg)
        params = variables["params"]
        schedule = jax_optim.make_lr_schedule(LR, steps_per_epoch, milestones=[10], gamma=0.1,
                                              warmup_factor=1e-3, warmup_steps=min(1000, steps_per_epoch))
        frozen = frozen_param_predicate(jcfg.backbone_freeze_indices)
        tx = jax_optim.build_optimizer(params, schedule, WD, BETAS, MAX_NORM, frozen_predicate=frozen)
        trainable = jax.tree_util.tree_map_with_path(
            lambda p, _: not frozen(jax_optim._strip_backbone(p)), params)
        self.draws, self.norms = [], []
        self.accumulate_steps = accumulate_steps
        self.cdn = self.model.bind({"params": params}).denoising_generator

        def probe_update(grads, state, params=None):
            kept = jax.tree.map(lambda g, t: g if t else jnp.zeros_like(g), grads, trainable)
            return grads, NormProbeState(optax.global_norm(kept))

        probe = optax.GradientTransformation(lambda p: NormProbeState(jnp.zeros((), jnp.float32)), probe_update)
        tx = optax.chain(probe, tx)
        self.state = TrainState(step=jnp.zeros((), jnp.int32), params=params, frozen=variables["frozen"],
                                batch_stats=variables["batch_stats"], opt_state=tx.init(params))
        self.step_fn = jax_make_train_step(self.model, crit, sal, tx, jax_weight_dict(jcfg.num_decoder_layers),
                                           donate=False, accumulate_steps=accumulate_steps)

    def interceptor(self, next_fun, args, kwargs, context):
        return next_fun(*args, **kwargs)

    def cdn_draws(self, batch, key):
        """The CDN draws of each micro-batch of a step on ``key``."""
        A = max(self.accumulate_steps, 1)
        keys = [key] if A == 1 else list(jax.random.split(key, A))
        micro = len(batch["labels"]) // A
        return [[np.asarray(x) for x in jax_cdn_draws(
            self.cdn, RootDenoisingRng().apply({}, rngs={"denoising": jax.random.split(k)[0]}), micro)]
            for k in keys]

    def step(self, batch, key):
        jbatch = {k: jnp.asarray(batch[k]) for k in ("image_sizes", "boxes", "labels", "gt_valid")}
        jbatch["images"] = jax_normalize(jnp.asarray(batch["images"], jnp.float32) / 255.0)
        key = jax.random.PRNGKey(key)
        with fnn.intercept_methods(self.interceptor):
            self.state, metrics = self.step_fn(self.state, jbatch, key)
        jax.effects_barrier()
        self.draws += self.cdn_draws(batch, key)
        self.norms.append(float(self.state.opt_state[0].norm))
        return {k: float(v) for k, v in metrics.items()}

    def state_dict(self, tcfg):
        s = jax.device_get(self.state)
        return state_dict_from_jax({"params": s.params, "frozen": s.frozen, "batch_stats": s.batch_stats}, tcfg)


class PortSide:
    def __init__(self, tcfg, variables, steps_per_epoch, accumulate_steps):
        self.model, _ = build_salience_detr(tcfg, torch.device("cpu"))
        self.model.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
        crit, sal = build_criteria(tcfg)
        optimizer = build_optimizer(self.model, LR, WD, BETAS)
        schedule = make_lr_schedule(LR, steps_per_epoch, [10], 0.1, 1e-3, min(1000, steps_per_epoch))
        self.step = make_train_step(self.model, crit, sal, optimizer, schedule,
                                    default_weight_dict(tcfg.num_decoder_layers), MAX_NORM,
                                    accumulate_steps=accumulate_steps)


def run_pair(root, seed, steps, accumulate_steps, edit_batch=None, batch=BATCH):
    """``steps`` paired steps; returns (per-step JAX metrics with the probe's
    norm, per-step port metrics, JAX and port state dicts before and after)."""
    jcfg, tcfg = tiny_configs()
    jmodel, *_ = build_jax(jcfg)
    variables = random_variables(jax_variable_shapes(jmodel), seed=seed)
    jax_batches, port_batches, steps_per_epoch = load_batches(root, seed, steps, batch)
    if edit_batch is not None:
        jax_batches = [edit_batch(b) for b in jax_batches]
        port_batches = [edit_batch(b) for b in port_batches]
    jside = JaxSide(jcfg, variables, steps_per_epoch, accumulate_steps)
    pside = PortSide(tcfg, variables, steps_per_epoch, accumulate_steps)
    init = state_dict_from_jax(variables, tcfg)
    jax_metrics, port_metrics = [], []
    for i, (jb, pb) in enumerate(zip(jax_batches, port_batches)):
        jm = jside.step(jb, 100 + i)
        jm["grad_norm_trainable"] = jside.norms[-1]
        jax_metrics.append(jm)
        draws = [torch_draws(*d) for d in jside.draws[-accumulate_steps:]]
        pm = pside.step(ploader.train_to_device(pb, torch.device("cpu")), draws=draws)
        port_metrics.append({k: float(v) for k, v in pm.items()})
    assert pside.step.steps_done == steps and int(jside.state.step) == steps
    return jax_metrics, port_metrics, init, jside.state_dict(tcfg), pside.model.state_dict()


def check_metrics(jax_metrics, port_metrics):
    for step, (jm, pm) in enumerate(zip(jax_metrics, port_metrics)):
        assert set(pm) | {"grad_norm_trainable"} == set(jm)
        for k, v in pm.items():
            want = jm["grad_norm_trainable"] if k == "grad_norm" else jm[k]
            np.testing.assert_allclose(v, want, rtol=RTOL, atol=ATOL, err_msg=f"step {step} {k}")
        assert np.isfinite(pm["loss"])


def check_states(init, jax_state, port_state):
    """Every parameter and buffer: max |port - JAX| <= 1e-3 max |JAX - init| +
    1e-6 (what the steps moved; frozen tensors must not move at all)."""
    assert set(port_state) >= set(jax_state)
    checked = 0
    for name, want in jax_state.items():
        got, start = port_state[name].float(), init[name]
        moved = float((want - start).abs().max())
        bound = 1e-3 * moved + 1e-6
        err = float((got - want).abs().max())
        assert err <= bound, (name, err, bound)
        checked += 1
    return checked


@pytest.fixture(scope="module", params=[2, 1], ids=["batch2", "batch1"])
def paired(request, tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("pair"), seed=0, steps=3, accumulate_steps=1, batch=request.param)


def test_three_steps_losses_and_grad_norm(paired):
    jax_metrics, port_metrics, *_ = paired
    assert len(port_metrics) == 3
    check_metrics(jax_metrics, port_metrics)
    # the loss terms move from step to step (the batches and the weights change)
    assert len({round(m["loss"], 6) for m in port_metrics}) == 3


def test_three_steps_parameters_and_statistics(paired):
    _, _, init, jax_state, port_state = paired
    assert check_states(init, jax_state, port_state) > 500
    moved = [n for n in jax_state if not torch.equal(jax_state[n], init[n])]
    assert len(moved) > 300
