"""The train and eval steps (port of salience_detr_tpu/parallel/train_step.py,
``accumulate_steps=1``, one device).

One step: the train forward under autocast (bf16 on CUDA when the config
asks for it, float32 master weights), the losses in float32 outside
autocast, backward, global-norm clipping over the trainable parameters,
the schedule's lr, and the AdamW update.  The step returns the weighted
losses, ``loss`` and ``grad_norm`` as device tensors; nothing leaves the
device inside the step.  ``grad_norm`` is the norm of the trainable
parameters' gradients, which the clip reads; the JAX step's metric also
counts the frozen parameters' gradients, which the port never computes.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch

from salience_detr_torch.engine.optim import clip_grad_global_norm_, set_lr
from salience_detr_torch.models.bricks.denoising import CDNDraws, cdn_draws
from salience_detr_torch.models.detectors.salience_detr import compute_loss


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


def make_train_step(model, criterion, salience_criterion, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable[[int], float], weight_dict: Dict[str, float],
                    max_norm: float = 0.1,
                    autocast_dtype: Optional[torch.dtype] = None) -> Callable:
    """``step(batch, generator=None, draws=None) -> metrics``: the CDN draws
    come from ``generator`` (a ``torch.Generator`` on the batch's device)
    unless given.  The model is put in train mode."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    dn = model.denoising_generator
    count = {"step": 0}

    def step(batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
             draws: Optional[CDNDraws] = None) -> Dict[str, torch.Tensor]:
        model.train()
        if draws is None:
            images = batch["images"]
            draws = cdn_draws(images.shape[0], dn.num_denoising_queries, dn.num_classes,
                              dn.label_noise_prob, generator, images.device)
        optimizer.zero_grad(set_to_none=True)
        total, losses, _ = forward_and_loss(
            model, batch, draws, criterion, salience_criterion, weight_dict, autocast_dtype
        )
        total.backward()
        grad_norm = clip_grad_global_norm_(params, max_norm)
        set_lr(optimizer, lr_schedule(count["step"]))
        optimizer.step()
        count["step"] += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return step


def make_eval_step(model, postprocess, dtype: torch.dtype = torch.float32) -> Callable:
    """Eval forward and post-process -> per-image top-k detections (the JAX
    package's ``make_eval_step``).  ``batch`` holds images (B, 3, H, W),
    normalized and padded, image_sizes and orig_sizes (B, 2); on CUDA the
    forward runs under autocast to ``dtype`` unless it is float32."""

    @torch.no_grad()
    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
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
