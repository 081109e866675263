"""Bytes and operations of one multi-scale deformable attention call, from its
shapes, and the least time the card needs for it.

Shapes: value (B, S, C), locations (B, Q, G, L, P, 2), weights (B, Q, H, L, P).
Each input is read once and each output written once.  The kernels read the
locations and weights as float32 and write float32 gradients of them, so
those count 4 bytes an element; the value, its gradient, the output and the
output's gradient count in the value's dtype.  Operations are the bilinear
corners' multiply-adds on every channel of each head (2 per corner channel,
4 corners a sample point) in the forward; the backward does twice that (the
value's gradient and the dot products behind the weights' and locations'
gradients).  The corners outside their level need no work, so these are the
most a call can need; the bytes bound every call of the benchmark's cells
(operations at most 0.75 of the bytes' time), so the count of in-level
corners never decides the bound."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence, Tuple

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
F32 = 4


def _sizes(value_shape: Sequence[int], loc_shape: Sequence[int], weight_shape: Sequence[int]):
    B, S, C = value_shape
    _, Q, G, L, P, two = loc_shape
    H = weight_shape[2]
    return B, S, C, Q, G, L, P, H


def forward_work(value_shape, loc_shape, weight_shape, value_bytes: int) -> Tuple[float, float]:
    """(bytes, operations) of the forward: value, locations and weights read,
    the (B, Q, C) output written in the value's dtype."""
    B, S, C, Q, G, L, P, H = _sizes(value_shape, loc_shape, weight_shape)
    small = F32 * (B * Q * G * L * P * 2 + B * Q * H * L * P)
    moved = B * S * C * value_bytes + small + B * Q * C * value_bytes
    return float(moved), float(2 * 4 * B * Q * C * L * P)


def backward_work(value_shape, loc_shape, weight_shape, value_bytes: int) -> Tuple[float, float]:
    """(bytes, operations) of the backward: value, locations, weights and the
    output's gradient read; the gradients of value, locations and weights
    written."""
    B, S, C, Q, G, L, P, H = _sizes(value_shape, loc_shape, weight_shape)
    small = F32 * (B * Q * G * L * P * 2 + B * Q * H * L * P)
    moved = 2 * B * S * C * value_bytes + B * Q * C * value_bytes + 2 * small
    return float(moved), float(2 * 2 * 4 * B * Q * C * L * P)


def least_seconds(moved: float, ops: float) -> Tuple[float, str]:
    """The larger of bytes over the HBM rate and float32 operations over the
    CUDA cores' rate, and which one it is."""
    by_bytes, by_ops = moved / PEAKS["hbm_bytes_per_s"], ops / PEAKS["f32_flops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


ELEMENT_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8}


def share(calls, work) -> float:
    """Percent of the least time over the device time, summed over ``calls``:
    [(the operator's trace event, device seconds of its kernels)], shapes
    and types from the event's recorded inputs; None without calls."""
    least = spent = 0.0
    for op, seconds in calls:
        args = op.get("args", {})
        dims, types = args.get("Input Dims"), args.get("Input type")
        if not dims or len(dims) < 3 or not dims[0]:
            continue
        moved, ops = work(dims[0], dims[1], dims[2], ELEMENT_BYTES.get(types[0], 4))
        least += least_seconds(moved, ops)[0]
        spent += seconds
    return 100.0 * least / spent if spent > 0 else None
