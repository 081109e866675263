"""Mask, multi-level and selection utilities (port of salience_detr_tpu/ops/misc.py).

Shapes stay static as in the JAX package: the padded canvas (H, W) and the
per-level feature shapes are Python ints, and per-image validity is carried as
``image_sizes: (B, 2) int`` [(h, w) valid pixels] from which every mask and
valid ratio is computed on the device.  Public functions keep the JAX layout
(channel-last feature maps) so that tests compare like with like.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Logit with the reference's asymmetric clamping."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def device_constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant on ``device`` without a stream synchronisation: a
    blocking host-to-device copy would make the host wait for the device."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def flat_levels(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """((h0, w0), (h1, w1), ...) -> [h0, w0, h1, w1, ...]: the levels as the
    kernels' registered operators take them (an ``int[]`` argument)."""
    return [int(n) for hw in spatial_shapes for n in hw]


def level_pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """[h0, w0, h1, w1, ...] -> ((h0, w0), (h1, w1), ...)."""
    return tuple((int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2))


def refuse_meta(t: torch.Tensor, name: str) -> None:
    """A registered operator's fake implementation serves tracing, whose
    FakeTensors report the device they stand for; a plain meta tensor has
    no kernel, as the wrappers before the operators said."""
    if t.device.type == "meta":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")


def stable_topk(x: torch.Tensor, k: int, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along ``dim`` in descending order, ties broken by lower index.

    ``jax.lax.top_k`` and ``jnp.argsort`` are stable and the model relies on
    it: padded tokens all share one minimum score.  ``torch.topk`` gives no
    order among equal values on CUDA, so every selection goes through here.
    """
    values, index = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), index.narrow(dim, 0, k)


def level_valid_sizes(
    image_sizes: torch.Tensor, canvas_hw: Tuple[int, int], feat_hw: Tuple[int, int]
) -> torch.Tensor:
    """Valid (h, w) extent of one feature level per image: feature row r is
    valid iff r < ceil(h * h_f / H), as nearest-neighbour downsampling of the
    binary canvas mask gives.  (B, 2) int -> (B, 2) int."""
    H, W = canvas_hw
    h_f, w_f = feat_hw
    vh = -torch.div(-image_sizes[:, 0] * h_f, H, rounding_mode="floor")
    vw = -torch.div(-image_sizes[:, 1] * w_f, W, rounding_mode="floor")
    return torch.stack([vh, vw], dim=-1)


def multi_level_valid_sizes(
    image_sizes: torch.Tensor,
    canvas_hw: Tuple[int, int],
    shapes: Sequence[Tuple[int, int]],
) -> List[torch.Tensor]:
    return [level_valid_sizes(image_sizes, canvas_hw, s) for s in shapes]


def rect_mask(valid_hw: torch.Tensor, feat_hw: Tuple[int, int]) -> torch.Tensor:
    """Padding mask, True = PADDING.  valid_hw (B, 2) -> (B, h_f, w_f) bool."""
    h_f, w_f = feat_hw
    rows = torch.arange(h_f, device=valid_hw.device)[None, :, None]
    cols = torch.arange(w_f, device=valid_hw.device)[None, None, :]
    valid = (rows < valid_hw[:, 0, None, None]) & (cols < valid_hw[:, 1, None, None])
    return ~valid


def valid_ratios(
    valid_hw_per_level: Sequence[torch.Tensor], shapes: Sequence[Tuple[int, int]]
) -> torch.Tensor:
    """(B, num_levels, 2) of (w_ratio, h_ratio)."""
    ratios = [
        torch.stack([vhw[:, 1].float() / w, vhw[:, 0].float() / h], dim=-1)
        for vhw, (h, w) in zip(valid_hw_per_level, shapes)
    ]
    return torch.stack(ratios, dim=1)


def flatten_multi_level(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B, h, w, C)...] -> (B, sum hw, C); [(B, h, w)...] -> (B, sum hw).

    Channel-last like the JAX function; an NCHW map ``f`` flattens to the same
    row-major token order with ``f.flatten(2).transpose(1, 2)``.
    """
    return torch.cat([f.flatten(1, 2) for f in feats], dim=1)


def scope(name: str):
    """The program names regions of its forward for a profiler; the
    reference names none."""
    return contextlib.nullcontext()
