"""Optimizer of the port (port of salience_detr_tpu/engine/optim.py): AdamW
with the reference's parameter groupings (``PARAM_GROUPINGS``: the default
six groups, ``finetune_backbone_param`` and
``finetune_backbone_with_no_norm_weight_decay``), the warmup + multi-step
schedule, and global-norm gradient clipping over the trainable parameters.

The groupings classify as the JAX ones do, on the JAX variable path that
the converter's rules give each parameter: the JAX classifiers read flax
names (Swin v2's ``qkv_bias``, EVA-02's ``ln_1``, FocalNet's ``ln``), which
the port's upstream names do not carry.

The JAX chain is freeze -> clip the global norm -> Adam (eps 1e-8) ->
decoupled weight decay -> lr multiplier -> schedule.  Frozen parameters have
``requires_grad=False`` here and are in no group; ``torch.optim.AdamW`` with
one group per (lr multiplier, weight decay) pair, its lr set to
schedule(step) * multiplier before each step, computes the same update:
p -= lr * mult * (adam + wd * p).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch
from torch import nn

LR_MULT = {
    "other": 1.0,
    "other_norm": 1.0,
    "backbone": 0.1,
    "backbone_norm": 0.1,
    "linear_projection": 0.1,
    "linear_projection_norm": 0.1,
}
WD_APPLIES = {
    "other": True,
    "backbone": True,
    "linear_projection": True,
    "other_norm": False,
    "backbone_norm": False,
    "linear_projection_norm": False,
}


def param_group_of(path: Tuple[str, ...]) -> str:
    """The group of the JAX variable at ``path`` (its flax path without the
    collection): backbone and deformable-attention projections
    (sampling_offsets / reference_points) at 0.1x lr; a leaf named "bias", or
    a path component containing "norm", without weight decay."""
    is_backbone = path[0] == "backbone"
    is_proj = any(c in ("sampling_offsets", "reference_points") for c in path)
    is_norm_bias = path[-1] == "bias" or any("norm" in c for c in path)
    if is_backbone and not is_proj:
        return "backbone_norm" if is_norm_bias else "backbone"
    if is_proj and not is_backbone:
        return "linear_projection_norm" if is_norm_bias else "linear_projection"
    return "other_norm" if is_norm_bias else "other"


def _is_norm_module_comp(c: str) -> bool:
    """Whether a flax path component names a normalization module (the JAX
    package's naming: *norm*, bn*, *_bn, fbn, ln, ln_*, *_ln, gn)."""
    c = c.lower()
    return ("norm" in c or c.startswith("bn") or c.endswith("_bn") or c in ("fbn", "ln", "gn")
            or c.startswith("ln_") or c.endswith("_ln"))


def backbone_group_of(path: Tuple[str, ...]) -> str:
    """finetune_backbone_param: the backbone at 0.1x lr, everything else at
    1x, weight decay everywhere."""
    return "backbone" if path[0] == "backbone" else "other"


def no_norm_wd_group_of(path: Tuple[str, ...]) -> str:
    """finetune_backbone_with_no_norm_weight_decay: a normalization module's
    parameters (weight and bias; not the biases of other modules) without
    weight decay, the backbone at 0.1x lr."""
    prefix = "backbone" if path[0] == "backbone" else "other"
    return f"{prefix}_norm" if any(_is_norm_module_comp(c) for c in path[:-1]) else prefix


# grouping name -> (classifier of a JAX variable path, lr multipliers, weight
# decay applies); a train config selects one by ``param_dicts``
PARAM_GROUPINGS = {
    "finetune_backbone_and_linear_projection": (param_group_of, LR_MULT, WD_APPLIES),
    "finetune_backbone_param": (
        backbone_group_of, {"other": 1.0, "backbone": 0.1}, {"other": True, "backbone": True},
    ),
    "finetune_backbone_with_no_norm_weight_decay": (
        no_norm_wd_group_of,
        {"other": 1.0, "other_norm": 1.0, "backbone": 0.1, "backbone_norm": 0.1},
        {"other": True, "backbone": True, "other_norm": False, "backbone_norm": False},
    ),
}


def param_path(name: str) -> Tuple[str, ...]:
    """The path the groupings classify, from a parameter's name: its
    components, a merged attention bias named ``bias`` and the mask
    predictor's leading LayerNorm named ``norm`` (the names the upstream
    model's variables carry there)."""
    comps = name.split(".")
    if comps[-1] == "in_proj_bias":
        comps[-1] = "bias"
    if name.startswith("transformer.enc_mask_predictor.layer1.0."):
        comps[-2] = "norm"
    return tuple(comps)


def named_param_groups(model: nn.Module,
                       grouping: str = "finetune_backbone_and_linear_projection") -> Dict[str, str]:
    """{parameter name: group} for every trainable parameter."""
    classify = PARAM_GROUPINGS[grouping][0]
    return {name: classify(param_path(name)) for name, p in model.named_parameters() if p.requires_grad}


def make_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    milestones: Sequence[int] = (10,),
    gamma: float = 0.1,
    warmup_factor: float = 1.0 / 1000,
    warmup_steps: int = None,
) -> Callable[[int], float]:
    """Warmup (linear from ``warmup_factor``, epoch 0 only) and multi-step
    epoch decay, as a function of the step."""
    if warmup_steps is None:
        warmup_steps = min(1000, steps_per_epoch)

    def schedule(step: int) -> float:
        warm = 1.0
        if step < warmup_steps:
            warm = warmup_factor + (1.0 - warmup_factor) * step / max(warmup_steps, 1)
        decay = gamma ** sum(step >= m * steps_per_epoch for m in milestones)
        return base_lr * warm * decay

    return schedule


def build_optimizer(
    model: nn.Module,
    base_lr: float = 1e-4,
    weight_decay: float = 1e-4,
    betas: Tuple[float, float] = (0.9, 0.999),
    grouping: str = "finetune_backbone_and_linear_projection",
) -> torch.optim.AdamW:
    """AdamW over the trainable parameters, one group per (lr multiplier,
    weight decay) of the ``grouping``; each group carries its ``lr_mult``."""
    if grouping not in PARAM_GROUPINGS:
        raise ValueError(f"unknown param_dicts {grouping!r}; one of {sorted(PARAM_GROUPINGS)}")
    _, lr_mult, wd_applies = PARAM_GROUPINGS[grouping]
    params = dict(model.named_parameters())
    buckets: Dict[Tuple[float, float], list] = {}
    for name, group in named_param_groups(model, grouping).items():
        key = (lr_mult[group], weight_decay if wd_applies[group] else 0.0)
        buckets.setdefault(key, []).append(params[name])
    groups = [
        {"params": ps, "lr": base_lr * mult, "lr_mult": mult, "weight_decay": wd}
        for (mult, wd), ps in buckets.items()
    ]
    return torch.optim.AdamW(groups, lr=base_lr, betas=betas, eps=1e-8, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]


@torch.no_grad()
def clip_grad_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm of the
    gradients exceeds ``max_norm`` they are scaled by max_norm / norm (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).  Returns the norm
    before clipping, on the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    torch._foreach_mul_(grads, scale)
    return norm
