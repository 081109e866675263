"""The train and eval steps (port of salience_detr_tpu/parallel/train_step.py,
one device).

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

The step returns the weighted losses, ``loss`` and ``grad_norm`` as device
tensors; nothing leaves the device inside the step.  ``grad_norm`` is the
norm of the trainable parameters' gradients, which the clip reads; the JAX
step's metric also counts the frozen parameters' gradients, which the port
never computes.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from salience_detr_torch.engine.optim import clip_grad_global_norm_, set_lr
from salience_detr_torch.models.bricks.criterion import Targets
from salience_detr_torch.models.bricks.denoising import CDNDraws, cdn_draws
from salience_detr_torch.models.detectors.salience_detr import compute_loss
from salience_detr_torch.models.layers import set_drop_path_generator


def forward_and_loss(model, batch: Dict[str, Any], draws: CDNDraws, criterion,
                     salience_criterion, weight_dict: Dict[str, float],
                     autocast_dtype: Optional[torch.dtype] = None):
    """Train forward and weighted losses; returns (total, losses, outputs).
    ``batch`` holds images (B, 3, H, W), image_sizes (B, 2) and targets
    (``criterion.Targets``); num_boxes is the clamped count of valid gts,
    taken from the targets' host counts."""
    images, image_sizes, targets = batch["images"], batch["image_sizes"], batch["targets"]
    num_boxes = float(max(sum(targets.counts), 1))
    amp = (
        torch.autocast(images.device.type, dtype=autocast_dtype)
        if autocast_dtype is not None
        else contextlib.nullcontext()
    )
    with amp:
        outputs = model(images, image_sizes, targets, draws)
    losses = compute_loss(
        outputs, targets, image_sizes, criterion, salience_criterion, num_boxes, weight_dict,
        model.denoising_nums,
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
    one set per micro-batch, unless given (one ``CDNDraws`` per micro-batch);
    so do the backbone's stochastic-depth masks (``DropPath``).
    ``steps_done`` is the schedule's step; a resumed run sets it.  The model
    is put in train mode."""

    def __init__(self, model, criterion, salience_criterion, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], weight_dict: Dict[str, float], max_norm: float = 0.1,
                 autocast_dtype: Optional[torch.dtype] = None, accumulate_steps: int = 1,
                 scaler: Optional[torch.amp.GradScaler] = None):
        self.model, self.criterion, self.salience_criterion = model, criterion, salience_criterion
        self.optimizer, self.lr_schedule, self.weight_dict = optimizer, lr_schedule, weight_dict
        self.max_norm, self.autocast_dtype, self.scaler = max_norm, autocast_dtype, scaler
        self.accumulate_steps = max(accumulate_steps, 1)
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.steps_done = 0

    def __call__(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 draws: Union[CDNDraws, Sequence[CDNDraws], None] = None) -> Dict[str, torch.Tensor]:
        model, A = self.model, self.accumulate_steps
        model.train()
        set_drop_path_generator(model, generator)
        micro = split_batch(batch, A) if A > 1 else [batch]
        if draws is None:
            dn = model.denoising_generator
            draws = [cdn_draws(mb["images"].shape[0], dn.num_denoising_queries, dn.num_classes,
                               dn.label_noise_prob, generator, mb["images"].device) for mb in micro]
        elif isinstance(draws, CDNDraws):
            draws = [draws]
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = None, None
        for mb, mb_draws in zip(micro, draws):
            t, l, _ = forward_and_loss(model, mb, mb_draws, self.criterion, self.salience_criterion,
                                       self.weight_dict, self.autocast_dtype)
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
