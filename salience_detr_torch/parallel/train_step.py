"""The train and eval steps (port of salience_detr_tpu/parallel/train_step.py).

One step: the train forward under autocast (bf16 or fp16 on CUDA when the
config asks for it, float32 master weights), the losses in float32 outside
autocast, backward, global-norm clipping over the trainable parameters,
the schedule's lr, and the AdamW update.  With ``accumulate_steps`` A > 1 the
batch is split into A micro-batches run in order, each normalized by its own
clamped gt count and with its own CDN draws; the neck's BatchNorm statistics
carry from one micro-batch to the next; gradients, the total loss and each
loss term are averaged over A before the clip and the one optimizer step.
With a ``torch.amp.GradScaler`` (fp16) the loss is scaled for backward, the
gradients unscaled before the clip, and the scaler skips a step whose
gradients are not finite.

Data parallelism (a ``mesh`` of ``parallel/mesh.py`` under the launcher):
each of W ranks holds its rows of the global batch (``shard_batch``; rank r
holds slice r of each of the A micro-batches) and the step computes what the
JAX step computes on the whole global batch, up to the order of float sums:

* one host all-reduce a step (on the gloo side group, no device sync) of a
  (B + 1,) int64 tensor: the global batch's per-image gt counts, zero outside
  the rank's rows, and the stop flag of :meth:`TrainStep.should_stop`.  Each
  micro-batch's global counts give the CDN group shape (m, g) and the gt
  normaliser max(count, 1) / W (``criterion.Shard``);
* every rank seeds its generator alike and draws the CDN noise and the
  stochastic-depth masks at the global micro-batch's shape, keeping its rows;
* the neck's BatchNorm syncs its statistics over the default group
  (``layers.sync_batch_norm``; a world of one takes the local path), and the
  salience loss counts its positives over the global batch;
* the model runs under ``DistributedDataParallel``, which averages the
  gradients over the W ranks; each rank's losses are its sums over the
  global normaliser / W, so the average is the global batch's gradient.
  DDP's all-reduce overlaps the backward; micro-batches but the last run
  under ``no_sync()``.  Every trainable parameter gets a gradient in a
  train step (``tests/test_torch_port_ddp_unit.py`` checks the tiny
  model), so ``find_unused_parameters`` is off.  The buffers are not
  broadcast: the synced BatchNorm keeps its statistics equal on every rank
  and the frozen BatchNorms do not change.  The clip reads the all-reduced
  gradients, so ``grad_norm`` is the global norm, and a non-finite gradient
  under fp16 is non-finite on every rank, so every rank's GradScaler skips
  the same steps.

The step returns the weighted losses, ``loss`` and ``grad_norm`` as device
tensors; nothing leaves the device inside the step.  In a data-parallel step
the losses are the rank's (their mean over the ranks is the global batch's:
:func:`parallel.mesh.mean_over_ranks`, which the train loop calls only
when it logs).
``grad_norm`` is the norm of the trainable parameters' gradients, which the
clip reads; the JAX step's metric also counts the frozen parameters'
gradients, which the port never computes.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from salience_detr_torch.engine.optim import clip_grad_global_norm_, set_lr
from salience_detr_torch.models.bricks.criterion import Shard, Targets, normaliser
from salience_detr_torch.models.bricks.denoising import CDNDraws, cdn_draws, rows_of
from salience_detr_torch.models.detectors.salience_detr import compute_loss
from salience_detr_torch.models.layers import set_drop_path_generator, sync_batch_norm
from salience_detr_torch.parallel.mesh import Mesh


def forward_and_loss(model, batch: Dict[str, Any], draws: CDNDraws, criterion,
                     salience_criterion, weight_dict: Dict[str, float],
                     autocast_dtype: Optional[torch.dtype] = None, denoising_nums: Optional[int] = None):
    """Train forward and weighted losses; returns (total, losses, outputs).
    ``batch`` holds images (B, 3, H, W), image_sizes (B, 2) and targets
    (``criterion.Targets``); num_boxes is the clamped count of valid gts,
    taken from the targets' host counts (the global batch's over the world
    size in a data-parallel step).  ``model`` may be the DDP wrapper, then
    ``denoising_nums`` is the model's."""
    images, image_sizes, targets = batch["images"], batch["image_sizes"], batch["targets"]
    amp = (
        torch.autocast(images.device.type, dtype=autocast_dtype)
        if autocast_dtype is not None
        else contextlib.nullcontext()
    )
    with amp:
        outputs = model(images, image_sizes, targets, draws)
    losses = compute_loss(
        outputs, targets, image_sizes, criterion, salience_criterion, normaliser(targets), weight_dict,
        denoising_nums if denoising_nums is not None else model.denoising_nums,
    )
    total = torch.stack([v.float() for v in losses.values()]).sum()
    return total, losses, outputs


def split_batch(batch: Dict[str, Any], parts: int) -> List[Dict[str, Any]]:
    """``parts`` micro-batches of consecutive images; raises when the batch
    size is not divisible by ``parts``."""
    B = batch["images"].shape[0]
    if B % parts:
        raise ValueError(f"batch size {B} is not divisible by --accumulate-steps {parts}")
    n, t = B // parts, batch["targets"]
    return [
        {"images": batch["images"][a * n:(a + 1) * n], "image_sizes": batch["image_sizes"][a * n:(a + 1) * n],
         "targets": Targets(t.labels[a * n:(a + 1) * n], t.boxes[a * n:(a + 1) * n],
                            t.valid[a * n:(a + 1) * n], tuple(t.counts[a * n:(a + 1) * n]))}
        for a in range(parts)
    ]


class TrainStep:
    """``step(batch, generator=None, draws=None) -> metrics``: the CDN draws
    come from ``generator`` (a ``torch.Generator`` on the batch's device),
    one set per micro-batch, unless given (one ``CDNDraws`` per micro-batch,
    made for the global micro-batch in a data-parallel step); so do the
    backbone's stochastic-depth masks (``DropPath``).  ``steps_done`` is the
    schedule's step; a resumed run sets it.  The model is put in train mode.
    ``mesh`` (a distributed ``parallel.mesh.Mesh``) makes it a data-parallel
    step over the rank's rows of each global batch; ``stop_source``, when
    set, is this process's stop flag, which the ranks agree on through
    :meth:`should_stop`."""

    def __init__(self, model, criterion, salience_criterion, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], weight_dict: Dict[str, float], max_norm: float = 0.1,
                 autocast_dtype: Optional[torch.dtype] = None, accumulate_steps: int = 1,
                 scaler: Optional[torch.amp.GradScaler] = None, mesh: Optional[Mesh] = None):
        self.model, self.criterion, self.salience_criterion = model, criterion, salience_criterion
        self.optimizer, self.lr_schedule, self.weight_dict = optimizer, lr_schedule, weight_dict
        self.max_norm, self.autocast_dtype, self.scaler = max_norm, autocast_dtype, scaler
        self.accumulate_steps = max(accumulate_steps, 1)
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.steps_done = 0
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self.stop_source: Optional[Callable[[], bool]] = None
        self._agreed_stop = False
        self.forward_model = model
        if self.mesh is not None:
            sync_batch_norm(model, dist.group.WORLD)
            self.forward_model = DistributedDataParallel(model, broadcast_buffers=False)

    def should_stop(self) -> bool:
        """Whether to stop after this step: the stop source's flag, agreed by
        every rank at the last step's all-reduce in a data-parallel step."""
        if self.mesh is not None:
            return self._agreed_stop
        return bool(self.stop_source is not None and self.stop_source())

    def _shards(self, micro: List[Dict[str, Any]]) -> List[Shard]:
        """One all-reduce of the global counts and the stop flags; each
        micro-batch's ``Shard``."""
        mesh, A = self.mesh, len(micro)
        b = micro[0]["images"].shape[0]
        B = b * A * mesh.world
        local = torch.zeros(B + 1, dtype=torch.int64)
        rows = mesh.rows(B, A)
        local[rows] = torch.tensor([n for mb in micro for n in mb["targets"].counts], dtype=torch.int64)
        local[B] = int(bool(self.stop_source is not None and self.stop_source()))
        reduced = mesh.host_sum(local).tolist()
        self._agreed_stop = reduced[B] > 0
        per = B // A
        return [Shard(tuple(reduced[a * per:(a + 1) * per]), mesh.rank * b, mesh.world) for a in range(A)]

    def __call__(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 draws: Union[CDNDraws, Sequence[CDNDraws], None] = None) -> Dict[str, torch.Tensor]:
        model, A = self.model, self.accumulate_steps
        model.train()
        micro = split_batch(batch, A) if A > 1 else [dict(batch)]
        shards = self._shards(micro) if self.mesh is not None else [None] * A
        if shards[0] is not None:
            for mb, shard in zip(micro, shards):
                mb["targets"] = mb["targets"]._replace(shard=shard)
        b = micro[0]["images"].shape[0]
        offset, rows = (0, b) if shards[0] is None else (shards[0].offset, len(shards[0].counts))
        set_drop_path_generator(model, generator, None if shards[0] is None else (offset, rows))
        if draws is None:
            dn = model.denoising_generator
            draws = [cdn_draws(rows, dn.num_denoising_queries, dn.num_classes, dn.label_noise_prob, generator,
                               mb["images"].device) for mb in micro]
        elif isinstance(draws, CDNDraws):
            draws = [draws]
        draws = [rows_of(d, offset, b) for d in draws]
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = None, None
        for a, (mb, mb_draws) in enumerate(zip(micro, draws)):
            sync = self.mesh is None or a == A - 1
            with contextlib.nullcontext() if sync else self.forward_model.no_sync():
                t, l, _ = forward_and_loss(self.forward_model, mb, mb_draws, self.criterion,
                                           self.salience_criterion, self.weight_dict, self.autocast_dtype,
                                           model.denoising_nums)
                scaled = t / A if A > 1 else t
                (self.scaler.scale(scaled) if self.scaler is not None else scaled).backward()
            t, l = t.detach(), {k: v.detach() for k, v in l.items()}
            total = t if total is None else total + t
            losses = l if losses is None else {k: losses[k] + v for k, v in l.items()}
        if A > 1:
            total = total / A
            losses = {k: v / A for k, v in losses.items()}
        if self.scaler is not None:
            self.scaler.unscale_(self.optimizer)
        grad_norm = clip_grad_global_norm_(self.params, self.max_norm)
        set_lr(self.optimizer, self.lr_schedule(self.steps_done))
        if self.scaler is not None:
            self.scaler.step(self.optimizer)
            self.scaler.update()
        else:
            self.optimizer.step()
        self.steps_done += 1
        metrics = dict(losses)
        metrics["loss"] = total
        metrics["grad_norm"] = grad_norm
        return metrics


make_train_step = TrainStep  # the JAX package's name


def make_eval_step(model, postprocess, dtype: torch.dtype = torch.float32) -> Callable:
    """Eval forward and post-process -> per-image top-k detections (the JAX
    package's ``make_eval_step``).  ``batch`` holds images (B, 3, H, W),
    normalized and padded, image_sizes and orig_sizes (B, 2); on CUDA the
    forward runs under autocast to ``dtype`` unless it is float32.  The model
    is put in eval mode (the neck's BatchNorm reads its running statistics
    and leaves them as they are)."""

    @torch.no_grad()
    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model.eval()
        images = batch["images"]
        amp = (
            torch.autocast("cuda", dtype=dtype)
            if images.device.type == "cuda" and dtype != torch.float32
            else contextlib.nullcontext()
        )
        with amp:
            out = model(images, batch["image_sizes"])
        return postprocess(out["pred_class"][-1], out["pred_coord"][-1], batch["orig_sizes"])

    return step
