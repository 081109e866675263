"""The weights of a run: made on the device from the seed, in float32, in
two large draws (one uniform, one normal) that every leaf takes a slice of.

The distributions are the program's initialisers at a random start (kaiming
for convolutions, xavier for linear layers, the focal prior on the class
heads, the directional bias of the sampling offsets), with two departures
that make the deformable attention sample as a trained model does, each
query its own locations and weights: the sampling-offset and
attention-weight projections, and the box heads' last layer, draw small
uniform weights where the initialiser writes zeros."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from portbench.reference import attention, layers, transformer as tr

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
SMALL = 0.1  # bound of the small uniform draws (sampling offsets, attention weights)
BOX_SMALL = 0.01  # bound of the box heads' last layer


def _plan(model: nn.Module) -> List[Tuple[str, tuple, str, float, float]]:
    """(name, shape, kind, a, b) per state-dict entry: kind ``u`` is
    a + (b - a) * uniform, ``n`` is b * normal, ``c`` the constant a."""
    plan = {}
    t = model.transformer
    heads = {id(m) for m in [t.encoder_class_head, *t.decoder.class_head]}
    box_last = {id(mlp.layers[-1]) for mlp in [t.encoder_bbox_head, *t.decoder.bbox_head]}
    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            if mname.startswith("backbone."):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                plan[p + "weight"] = ("n", 0.0, math.sqrt(2.0 / fan_out))
            else:
                plan[p + "weight"] = ("u", -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in))
            if m.bias is not None:
                plan[p + "bias"] = ("u", -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in))
        elif isinstance(m, nn.Linear):
            fan_out, fan_in = m.weight.shape
            if id(m) in heads:
                bound = 1 / math.sqrt(fan_in)
                plan[p + "weight"] = ("u", -bound, bound)
                plan[p + "bias"] = ("c", PRIOR_BIAS, 0.0)
            elif id(m) in box_last:
                plan[p + "weight"] = ("u", -BOX_SMALL, BOX_SMALL)
                plan[p + "bias"] = ("c", 0.0, 0.0)
            else:
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                plan[p + "weight"] = ("u", -bound, bound)
                plan[p + "bias"] = ("c", 0.0, 0.0)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d, layers.FrozenBatchNorm2d)):
            plan[p + "weight"] = ("c", 1.0, 0.0)
            plan[p + "bias"] = ("c", 0.0, 0.0)
            if isinstance(m, (nn.BatchNorm2d, layers.FrozenBatchNorm2d)):
                plan[p + "running_mean"] = ("c", 0.0, 0.0)
                plan[p + "running_var"] = ("c", 1.0, 0.0)
            if isinstance(m, nn.BatchNorm2d):
                plan[p + "num_batches_tracked"] = ("c", 0.0, 0.0)
        elif isinstance(m, nn.Embedding):
            plan[p + "weight"] = ("n", 0.0, 1.0)
        elif isinstance(m, attention.MultiheadAttention):
            C = m.in_proj_weight.shape[1]
            bound = math.sqrt(6.0 / (C + 3 * C))
            plan[p + "in_proj_weight"] = ("u", -bound, bound)
            plan[p + "in_proj_bias"] = ("c", 0.0, 0.0)
    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(m, attention.MultiScaleDeformableAttention):
            plan[p + "sampling_offsets.weight"] = ("u", -SMALL, SMALL)
            plan[p + "sampling_offsets.bias"] = ("grid", m.sampling_groups, (m.num_levels, m.num_points))
            plan[p + "attention_weights.weight"] = ("u", -SMALL, SMALL)
            plan[p + "attention_weights.bias"] = ("c", 0.0, 0.0)
        elif isinstance(m, tr.BackgroundEmbedding):
            plan[p + "row_embed.weight"] = ("u", 0.0, 1.0)
            plan[p + "col_embed.weight"] = ("u", 0.0, 1.0)
    plan["transformer.level_embeds"] = ("n", 0.0, 1.0)
    plan["transformer.alpha"] = ("u", -0.3, 0.3)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(shapes) - set(plan))
    if missing:
        raise KeyError(f"no initialiser for {missing[:5]} ({len(missing)} entries)")
    return [(k, shapes[k], *plan[k]) for k in shapes]


def make_state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model``'s layout from ``seed``, float32 on
    ``device`` (``num_batches_tracked`` int64)."""
    plan = _plan(model)
    gen = torch.Generator(device=device).manual_seed(seed % (2**63))
    n_u = sum(math.prod(s) for _, s, kind, *_ in plan if kind == "u")
    n_n = sum(math.prod(s) for _, s, kind, *_ in plan if kind == "n")
    uni = torch.rand(n_u, generator=gen, device=device)
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, kind, a, b in plan:
        n = math.prod(shape)
        if kind == "u":
            t = uni[iu:iu + n].view(shape) * (b - a) + a
            iu += n
        elif kind == "n":
            t = nor[inn:inn + n].view(shape) * b + a
            inn += n
        elif kind == "grid":
            levels, points = b
            grid = attention.offset_bias_grid(a, levels, points)
            t = torch.from_numpy(grid).float().to(device)
        else:
            t = torch.full(shape, a, dtype=torch.float32, device=device)
        if name.endswith("num_batches_tracked"):
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        out[name] = t.contiguous()
    return out
