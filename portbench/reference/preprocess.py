"""The serving path's preprocessing: OpenCV's uint8 INTER_LINEAR resize
(short side ``min_size``, long side at most ``max_size``, truncated
sizes), padding at the top left of a landscape (min x max, rounded up to 32)
or portrait canvas, scaling to [0, 1] and ImageNet normalisation."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _linear_taps(n_in: int, n_out: int, clamp_border: bool):
    """Source indices and 11-bit fixed-point weights of OpenCV's INTER_LINEAR
    resampling of ``n_in`` samples to ``n_out``.  Past the borders OpenCV
    zeroes the horizontal fraction but keeps the vertical one."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    i0 = np.floor(f)
    f -= i0
    i0 = i0.astype(np.int64)
    if clamp_border:
        f[(i0 < 0) | (i0 >= n_in - 1)] = 0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, i1, np.rint((1 - f) * 2048).astype(np.int32), np.rint(f * 2048).astype(np.int32)


def resize_u8(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(h, w, 3) uint8 -> (nh, nw, 3) uint8 in OpenCV's arithmetic: the
    horizontal pass exact, the vertical one with 16-bit high products and a
    rounding shift."""
    x0, x1, a0, a1 = (torch.from_numpy(t).to(img.device) for t in _linear_taps(img.shape[1], nw, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(img.device) for t in _linear_taps(img.shape[0], nh, False))
    px = img.to(torch.int32)
    rows = (a0[:, None] * px[:, x0] + a1[:, None] * px[:, x1]) >> 4
    out = ((b0[:, None, None] * rows[y0]) >> 16) + ((b1[:, None, None] * rows[y1]) >> 16)
    return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def _round_up(x: int, m: int = 32) -> int:
    return -(-x // m) * m


def canvas_for(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    short, long = _round_up(min_size), _round_up(max_size)
    return (short, long) if w >= h else (long, short)


def resized_size(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    r = min(min_size / min(h, w), max_size / max(h, w))
    return int(h * r), int(w * r)


def preprocess(images: Sequence[np.ndarray], min_size: int, max_size: int, device):
    """Requests of one canvas (uint8 HWC) -> (images (B, 3, H, W) float32
    normalised, image_sizes (B, 2), orig_sizes (B, 2)) on ``device``."""
    canvas = canvas_for(*images[0].shape[:2], min_size, max_size)
    batch = torch.zeros((len(images), 3, *canvas), dtype=torch.float32, device=device)
    sizes, orig = [], []
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        assert canvas_for(h, w, min_size, max_size) == canvas, "one canvas per call"
        nh, nw = resized_size(h, w, min_size, max_size)
        x = resize_u8(torch.from_numpy(np.ascontiguousarray(img)).to(device), nh, nw)
        batch[i, :, :nh, :nw] = x.permute(2, 0, 1).float() / 255.0
        sizes.append((nh, nw))
        orig.append((h, w))
    mean = torch.tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=device)[:, None, None]
    as_tensor = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return (batch - mean) / std, as_tensor(sizes), as_tensor(orig)
