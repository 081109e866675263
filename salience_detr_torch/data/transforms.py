"""Host-side train augmentations (the port's copy of
salience_detr_tpu/data/transforms.py), numpy plus cv2-free image operations.

The JAX package calls cv2 for its resizes, the HSV conversion, the JPEG
round trip, the blurs and copy-paste's mask resize and alpha blur; the
card's machine has no cv2.  The port computes each in OpenCV's own
arithmetic (:func:`resize_linear_u8` here, the rest in ``data/cv_ops.py``),
so a sample and a ``random.Random`` give byte-equal images, masks, equal
boxes and equal labels in both packages; every transform draws from the
``random.Random`` in the JAX class's order.

Presets (:func:`build_preset`, each call a fresh object): ``basic``,
``hflip``, ``multiscale``, ``detr`` (the default train preset), ``lsj``,
``lsj_1536``, ``ssd``, ``ssdlite``, ``strong_album``, ``rtdetr``,
``mosaic`` and ``mixup``.  :func:`simple_copy_paste` is the batch transform
of ``copypaste = True`` (samples with masks).

Sample dict contract: {"image": HxWx3 uint8 RGB, "boxes": (N, 4) float32
xyxy absolute, "labels": (N,) int64, optionally "masks": (N, H, W) bool}.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from salience_detr_torch.data import cv_ops

SCALES = [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]

Sample = Dict[str, np.ndarray]

def _linear_taps(n_in: int, n_out: int, clamp_border: bool):
    """Source indices and 11-bit fixed-point weights of OpenCV's INTER_LINEAR
    resampling of ``n_in`` samples to ``n_out``: out = w0 * in[i0] + w1 * in[i1].
    Past the borders OpenCV zeroes the horizontal fraction
    (``clamp_border``) but keeps the vertical one, reading the border row
    twice with both weights."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    i0 = np.floor(f)
    f -= i0
    i0 = i0.astype(np.int64)
    if clamp_border:
        f[(i0 < 0) | (i0 >= n_in - 1)] = 0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    i0 = np.clip(i0, 0, n_in - 1)
    w0 = np.rint((1 - f) * 2048).astype(np.int32)
    w1 = np.rint(f * 2048).astype(np.int32)
    return i0, i1, w0, w1


def resize_linear_u8(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(h, w, 3) uint8 -> (nh, nw, 3) uint8, byte-equal to
    ``cv2.resize(..., INTER_LINEAR)`` on uint8: an exact horizontal pass, then
    the vertical pass as OpenCV's vectorised path computes it (16-bit high
    products, rounding shift)."""
    x0, x1, a0, a1 = (torch.from_numpy(t).to(img.device) for t in _linear_taps(img.shape[1], nw, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(img.device) for t in _linear_taps(img.shape[0], nh, False))
    px = img.to(torch.int32)
    rows = (a0[:, None] * px[:, x0] + a1[:, None] * px[:, x1]) >> 4
    out = ((b0[:, None, None] * rows[y0]) >> 16) + ((b1[:, None, None] * rows[y1]) >> 16)
    return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def hflip(sample: Sample) -> Sample:
    img = sample["image"][:, ::-1]
    boxes = sample["boxes"].copy()
    w = img.shape[1]
    boxes[:, [0, 2]] = w - sample["boxes"][:, [2, 0]]
    out = {**sample, "image": np.ascontiguousarray(img), "boxes": boxes}
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = np.ascontiguousarray(sample["masks"][:, :, ::-1])
    return out


def vflip(sample: Sample) -> Sample:
    img = sample["image"][::-1]
    boxes = sample["boxes"].copy()
    h = img.shape[0]
    boxes[:, [1, 3]] = h - sample["boxes"][:, [3, 1]]
    out = {**sample, "image": np.ascontiguousarray(img), "boxes": boxes}
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = np.ascontiguousarray(sample["masks"][:, ::-1])
    return out


def resize(sample: Sample, size_hw) -> Sample:
    h, w = sample["image"].shape[:2]
    nh, nw = size_hw
    img = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(sample["image"])), nh, nw).numpy()
    boxes = sample["boxes"] * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
    out = {**sample, "image": img, "boxes": boxes.astype(np.float32)}
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = resize_masks(sample["masks"], nh, nw)
    return out


def resize_masks(masks: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(N, h, w) masks -> (N, nh, nw) uint8, as the JAX package's
    ``cv2.resize`` of the (h, w, N) uint8 stack with INTER_NEAREST (whose
    rows and columns it picks, without the transposes)."""
    h, w = masks.shape[1:]
    rows = np.take(masks.astype(np.uint8, copy=False), cv_ops.nearest_index(h, nh), axis=1)
    return np.take(rows, cv_ops.nearest_index(w, nw), axis=2)


def shortest_size(sample: Sample, min_size: int, max_size: Optional[int] = None) -> Sample:
    """Reference resize geometry: r = min(min/min_dim, max/max_dim);
    new = int(dim * r), truncated."""
    h, w = sample["image"].shape[:2]
    r = min_size / min(h, w)
    if max_size is not None:
        r = min(r, max_size / max(h, w))
    return resize(sample, (int(h * r), int(w * r)))


def crop(sample: Sample, top: int, left: int, height: int, width: int) -> Sample:
    img = sample["image"][top : top + height, left : left + width]
    boxes = sample["boxes"].copy()
    boxes[:, [0, 2]] -= left
    boxes[:, [1, 3]] -= top
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, width)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, height)
    out = {**sample, "image": np.ascontiguousarray(img), "boxes": boxes}
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = np.ascontiguousarray(sample["masks"][:, top : top + height, left : left + width])
    return out


def sanitize(sample: Sample, min_size: float = 1.0) -> Sample:
    """Drop degenerate boxes (SanitizeBoundingBox)."""
    b = sample["boxes"]
    keep = (b[:, 2] - b[:, 0] >= min_size) & (b[:, 3] - b[:, 1] >= min_size)
    out = {**sample, "boxes": b[keep], "labels": sample["labels"][keep]}
    for k in ("iscrowd", "area", "masks"):
        if k in sample and len(sample[k]) == len(b):
            out[k] = sample[k][keep]
        else:
            out.pop(k, None)
    return out


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample, rng: random.Random):
        return hflip(sample) if rng.random() < self.p else sample


class RandomShortestSize:
    def __init__(self, min_size, max_size: Optional[int] = None):
        self.min_sizes = [min_size] if isinstance(min_size, int) else list(min_size)
        self.max_size = max_size

    def __call__(self, sample, rng: random.Random):
        return shortest_size(sample, rng.choice(self.min_sizes), self.max_size)


class RandomSizeCrop:
    def __init__(self, min_size: int, max_size: int):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, sample, rng: random.Random):
        h, w = sample["image"].shape[:2]
        ch = rng.randint(self.min_size, max(min(h, self.max_size), self.min_size))
        cw = rng.randint(self.min_size, max(min(w, self.max_size), self.min_size))
        ch, cw = min(ch, h), min(cw, w)
        top = rng.randint(0, h - ch)
        left = rng.randint(0, w - cw)
        return crop(sample, top, left, ch, cw)


class RandomCropPad:
    """RandomCrop(pad_if_needed=True) of the lsj presets."""

    def __init__(self, size_hw, fill=(123.0, 117.0, 104.0)):
        self.size = size_hw
        self.fill = np.asarray(fill, np.uint8)

    def __call__(self, sample, rng: random.Random):
        th, tw = self.size
        h, w = sample["image"].shape[:2]
        if h < th or w < tw:
            pad_img = np.empty((max(h, th), max(w, tw), 3), np.uint8)
            pad_img[:] = self.fill
            pad_img[:h, :w] = sample["image"]
            sample = {**sample, "image": pad_img}
            h, w = pad_img.shape[:2]
        top = rng.randint(0, h - th)
        left = rng.randint(0, w - tw)
        return crop(sample, top, left, th, tw)


class ScaleJitter:
    """torchvision ScaleJitter: scale in [0.1, 2.0] of target/current."""

    def __init__(self, target_size, scale_range=(0.1, 2.0)):
        self.target = target_size
        self.range = scale_range

    def __call__(self, sample, rng: random.Random):
        h, w = sample["image"].shape[:2]
        scale = self.range[0] + rng.random() * (self.range[1] - self.range[0])
        r = min(self.target[0] / h, self.target[1] / w) * scale
        return resize(sample, (max(int(h * r), 1), max(int(w * r), 1)))


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample, rng: random.Random):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class RandomChoice:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample, rng: random.Random):
        return rng.choice(self.transforms)(sample, rng)


class Sanitize:
    def __init__(self, min_size: float = 1.0):
        self.min_size = min_size

    def __call__(self, sample, rng: random.Random):
        return sanitize(sample, self.min_size)


class Resize:
    def __init__(self, size_hw):
        self.size = size_hw

    def __call__(self, sample, rng: random.Random):
        return resize(sample, self.size)


class Mosaic:
    """4-image mosaic on a 2x2 canvas.  Draws its three extra samples from
    the dataset given to :meth:`set_dataset` (``CocoDetection`` wires it)."""

    def __init__(self, size=(640, 640), p: float = 1.0):
        self.size = size
        self.p = p
        self.dataset = None

    def set_dataset(self, dataset):
        self.dataset = dataset

    def __call__(self, sample, rng: random.Random):
        if self.dataset is None or rng.random() >= self.p:
            return sample
        th, tw = self.size
        canvas = np.full((th * 2, tw * 2, 3), 114, np.uint8)
        boxes_all, labels_all = [], []
        cx = rng.randint(tw // 2, tw + tw // 2)
        cy = rng.randint(th // 2, th + th // 2)
        samples = [sample] + [
            self.dataset[rng.randrange(len(self.dataset))] for _ in range(3)
        ]
        regions = [  # (x0, y0, x1, y1) on the canvas per quadrant
            (0, 0, cx, cy), (cx, 0, tw * 2, cy), (0, cy, cx, th * 2), (cx, cy, tw * 2, th * 2),
        ]
        for s, (x0, y0, x1, y1) in zip(samples, regions):
            rw, rh = x1 - x0, y1 - y0
            s = shortest_size(s, min(rh, rw))
            img = s["image"][:rh, :rw]
            h, w = img.shape[:2]
            canvas[y0 : y0 + h, x0 : x0 + w] = img
            b = s["boxes"].copy()
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, w) + x0
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, h) + y0
            boxes_all.append(b)
            labels_all.append(s["labels"])
        out = {
            **{k: v for k, v in sample.items() if k not in ("area", "iscrowd")},
            "image": canvas,
            "boxes": np.concatenate(boxes_all).astype(np.float32),
            "labels": np.concatenate(labels_all),
        }
        return sanitize(out)


class MixUp:
    """Blend two samples and union their boxes; the second sample comes from
    the dataset given to :meth:`set_dataset`."""

    def __init__(self, alpha: float = 32.0, p: float = 0.5):
        self.alpha = alpha
        self.p = p
        self.dataset = None

    def set_dataset(self, dataset):
        self.dataset = dataset

    def __call__(self, sample, rng: random.Random):
        if self.dataset is None or rng.random() >= self.p:
            return sample
        other = self.dataset[rng.randrange(len(self.dataset))]
        h = max(sample["image"].shape[0], other["image"].shape[0])
        w = max(sample["image"].shape[1], other["image"].shape[1])
        lam = np.random.default_rng(rng.getrandbits(32)).beta(self.alpha, self.alpha)
        canvas = np.zeros((h, w, 3), np.float32)
        canvas[: sample["image"].shape[0], : sample["image"].shape[1]] += (
            lam * sample["image"].astype(np.float32)
        )
        canvas[: other["image"].shape[0], : other["image"].shape[1]] += (
            (1 - lam) * other["image"].astype(np.float32)
        )
        return {
            **{k: v for k, v in sample.items() if k not in ("area", "iscrowd")},
            "image": canvas.clip(0, 255).astype(np.uint8),
            "boxes": np.concatenate([sample["boxes"], other["boxes"]]).astype(np.float32),
            "labels": np.concatenate([sample["labels"], other["labels"]]),
        }


class RandomPhotometricDistort:
    """Brightness/contrast/saturation jitter (ssd and rtdetr presets)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample, rng: random.Random):
        img = sample["image"].astype(np.float32)
        if rng.random() < self.p:
            img = img * rng.uniform(0.875, 1.125)  # brightness
        if rng.random() < self.p:
            mean = img.mean()
            img = (img - mean) * rng.uniform(0.5, 1.5) + mean  # contrast
        if rng.random() < self.p:
            gray = img.mean(-1, keepdims=True)
            img = gray + (img - gray) * rng.uniform(0.5, 1.5)  # saturation
        return {**sample, "image": img.clip(0, 255).astype(np.uint8)}


class RandomZoomOut:
    """Place the image on a larger canvas (ssd and rtdetr presets)."""

    def __init__(self, fill=(123, 117, 104), side_range=(1.0, 4.0), p: float = 0.5):
        self.fill = np.asarray(fill, np.uint8)
        self.side_range = side_range
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        h, w = sample["image"].shape[:2]
        r = rng.uniform(*self.side_range)
        nh, nw = int(h * r), int(w * r)
        top = rng.randint(0, nh - h)
        left = rng.randint(0, nw - w)
        canvas = np.empty((nh, nw, 3), np.uint8)
        canvas[:] = self.fill
        canvas[top : top + h, left : left + w] = sample["image"]
        boxes = sample["boxes"] + np.array([left, top, left, top], np.float32)
        return {**sample, "image": canvas, "boxes": boxes}


class RandomIoUCrop:
    """torchvision v2 RandomIoUCrop: draw a min-IoU option, then up to
    ``trials`` random crops; accept when at least one box centre is inside
    and the largest box-vs-crop IoU clears the option; keep the boxes whose
    centre is inside, clamped."""

    OPTIONS = [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, None]

    def __init__(self, min_scale=0.3, max_scale=1.0, min_aspect=0.5,
                 max_aspect=2.0, trials: int = 40):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.min_aspect = min_aspect
        self.max_aspect = max_aspect
        self.trials = trials

    def __call__(self, sample, rng: random.Random):
        min_iou = rng.choice(self.OPTIONS)
        if min_iou is None or len(sample["boxes"]) == 0:
            return sample
        h, w = sample["image"].shape[:2]
        boxes = sample["boxes"]
        for _ in range(self.trials):
            cw = int(w * rng.uniform(self.min_scale, self.max_scale))
            ch = int(h * rng.uniform(self.min_scale, self.max_scale))
            if cw < 1 or ch < 1:
                continue
            aspect = cw / ch
            if not (self.min_aspect <= aspect <= self.max_aspect):
                continue
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            cx = (boxes[:, 0] + boxes[:, 2]) / 2
            cy = (boxes[:, 1] + boxes[:, 3]) / 2
            inside = (cx > left) & (cx < left + cw) & (cy > top) & (cy < top + ch)
            if not inside.any():
                continue
            bx = boxes[inside]
            ix1 = np.maximum(bx[:, 0], left)
            iy1 = np.maximum(bx[:, 1], top)
            ix2 = np.minimum(bx[:, 2], left + cw)
            iy2 = np.minimum(bx[:, 3], top + ch)
            inter = (ix2 - ix1).clip(0) * (iy2 - iy1).clip(0)
            area_b = (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1])
            iou = inter / (area_b + cw * ch - inter + 1e-9)
            if iou.max() < min_iou:
                continue
            kept = {
                **sample,
                "boxes": boxes[inside],
                "labels": sample["labels"][inside],
            }
            for k in ("iscrowd", "area", "masks"):
                if k in sample and len(sample[k]) == len(boxes):
                    kept[k] = sample[k][inside]
            return crop(kept, top, left, ch, cw)
        return sample


# ------------------------------------------------- albumentations-style ops
# the ops of the reference's strong_album preset, image-only and
# box-preserving except RandomShift


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample, rng: random.Random):
        return vflip(sample) if rng.random() < self.p else sample


class RandomShift:
    """A.ShiftScaleRotate(shift_limit, scale_limit=0, rotate_limit=0): a
    pure translation with a constant-0 border."""

    def __init__(self, shift_limit: float = 0.0625, p: float = 0.5):
        self.shift_limit = shift_limit
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        h, w = sample["image"].shape[:2]
        tx = int(round(rng.uniform(-self.shift_limit, self.shift_limit) * w))
        ty = int(round(rng.uniform(-self.shift_limit, self.shift_limit) * h))
        img = np.zeros_like(sample["image"])
        src = sample["image"]
        x0s, x1s = max(0, -tx), min(w, w - tx)
        y0s, y1s = max(0, -ty), min(h, h - ty)
        img[y0s + ty : y1s + ty, x0s + tx : x1s + tx] = src[y0s:y1s, x0s:x1s]
        boxes = sample["boxes"] + np.asarray([tx, ty, tx, ty], np.float32)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        return {**sample, "image": img, "boxes": boxes}


class RandomBrightnessContrast:
    """A.RandomBrightnessContrast(brightness_limit=(0.1, 0.3),
    contrast_limit=(0.1, 0.3)): img * alpha + beta * 255."""

    def __init__(self, brightness_limit=(0.1, 0.3), contrast_limit=(0.1, 0.3), p: float = 0.2):
        self.brightness = brightness_limit
        self.contrast = contrast_limit
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        alpha = 1.0 + rng.uniform(*self.contrast)
        beta = rng.uniform(*self.brightness)
        img = sample["image"].astype(np.float32) * alpha + beta * 255.0
        return {**sample, "image": img.clip(0, 255).astype(np.uint8)}


class RandomRGBShift:
    def __init__(self, limit: int = 10, p: float = 1.0):
        self.limit = limit
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        shift = np.asarray([rng.uniform(-self.limit, self.limit) for _ in range(3)], np.float32)
        img = sample["image"].astype(np.float32) + shift
        return {**sample, "image": img.clip(0, 255).astype(np.uint8)}


class RandomHSV:
    """A.HueSaturationValue(20, 30, 20) through OpenCV's uint8 HSV."""

    def __init__(self, hue: int = 20, sat: int = 30, val: int = 20, p: float = 1.0):
        self.hue, self.sat, self.val = hue, sat, val
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        hsv = cv_ops.rgb2hsv_u8(sample["image"]).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-self.hue, self.hue))) % 180
        hsv[..., 1] = (hsv[..., 1] + int(rng.uniform(-self.sat, self.sat))).clip(0, 255)
        hsv[..., 2] = (hsv[..., 2] + int(rng.uniform(-self.val, self.val))).clip(0, 255)
        return {**sample, "image": cv_ops.hsv2rgb_u8(hsv.astype(np.uint8))}


class RandomJPEG:
    """A.ImageCompression(quality 85-95): a JPEG round trip."""

    def __init__(self, quality=(85, 95), p: float = 0.2):
        self.quality = quality
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        q = rng.randint(*self.quality)
        return {**sample, "image": cv_ops.jpeg_roundtrip_u8(sample["image"], q)}


class RandomChannelShuffle:
    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        perm = [0, 1, 2]
        rng.shuffle(perm)
        return {**sample, "image": np.ascontiguousarray(sample["image"][:, :, perm])}


class RandomBlur:
    """A.OneOf([Blur(3), MedianBlur(3)])."""

    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        blur = cv_ops.box3_u8 if rng.random() < 0.5 else cv_ops.median3_u8
        return {**sample, "image": blur(sample["image"])}


class OneOf:
    """Apply exactly one of the given transforms (albumentations A.OneOf)."""

    def __init__(self, transforms: Sequence[Callable], p: float = 1.0):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, sample, rng: random.Random):
        if rng.random() >= self.p:
            return sample
        return rng.choice(self.transforms)(sample, rng)


# ------------------------------------------------------------ copy-paste


def simple_copy_paste(samples: List[Sample], rng: random.Random,
                      rows: Optional[Sequence[int]] = None) -> List[Sample]:
    """Batch-level SimpleCopyPaste: each image receives a random selection
    of the previous image's instances (the batch rolled by one), masked by
    the union of their blurred masks.  Samples carry masks
    (``CocoDetection(return_masks=True)``).  The selections are drawn in
    the JAX function's order, then the pairs are composited in threads
    (numpy releases the GIL for the image-sized work).  With ``rows`` (a
    rank's rows of the global batch) every pair's selection is still drawn,
    in order, but only the rows' pairs are composited and returned: the
    other members need only their ``masks``' length (the loader passes
    stand-ins for them), and a row's partner (``partners``) is read whole."""
    rolled = samples[-1:] + samples[:-1]
    pairs = []
    for target, paste in zip(samples, rolled):
        if "masks" not in paste or len(paste["masks"]) == 0 or "masks" not in target:
            pairs.append((target, paste, None))
            continue
        n = len(paste["masks"])
        pairs.append((target, paste, sorted(set(rng.randrange(n) for _ in range(n)))))  # draws with repeats
    # one intra-op thread each, as the loader's workers: the resize of a
    # paste image is a torch op
    if rows is not None:
        pairs = [pairs[i] for i in rows]
    with ThreadPoolExecutor(len(pairs), initializer=torch.set_num_threads, initargs=(1,)) as ex:
        return list(ex.map(lambda pair: _copy_paste_one(*pair), pairs))


def _rolled_partners(rows: Sequence[int], n: int) -> List[int]:
    """The members that ``rows`` of a batch of ``n`` paste from."""
    return [(r - 1) % n for r in rows]


simple_copy_paste.partners = _rolled_partners  # the members the loader must hold whole


def _copy_paste_one(sample: Sample, paste: Sample, sel: Optional[List[int]]) -> Sample:
    if sel is None:
        return sample
    p_masks = paste["masks"][sel]
    p_boxes = paste["boxes"][sel]
    p_labels = paste["labels"][sel]

    h, w = sample["image"].shape[:2]
    ph, pw = paste["image"].shape[:2]
    p_img = paste["image"]
    if (ph, pw) != (h, w):
        p_img = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(p_img)), h, w).numpy()
        p_masks = resize_masks(p_masks, h, w)
        p_boxes = p_boxes * np.asarray([w / pw, h / ph, w / pw, h / ph], np.float32)

    alpha = cv_ops.gaussian_blur5_f32(p_masks.any(0).astype(np.float32), 2.0)
    img = (
        sample["image"].astype(np.float32) * (1.0 - alpha[..., None])
        + p_img.astype(np.float32) * alpha[..., None]
    )
    # a 0/1 mask times (1 - alpha) is above 0.5 where the mask is set and
    # (1 - alpha) is: the JAX package's float test, without the float stack
    masks = sample["masks"].astype(bool, copy=False) & ((1.0 - alpha) > 0.5)[None]
    keep = masks.reshape(len(masks), -1).any(1)
    masks = masks[keep]
    # the boxes of the surviving target instances, from their masks
    rows, cols = masks.any(2), masks.any(1)
    H, W = masks.shape[1:]
    boxes = np.stack([cols.argmax(1), rows.argmax(1), W - cols[:, ::-1].argmax(1),
                      H - rows[:, ::-1].argmax(1)], 1).astype(np.float32).reshape(-1, 4)
    out = {
        **{k: v for k, v in sample.items() if k not in ("area", "iscrowd")},
        "image": img.clip(0, 255).astype(np.uint8),
        "masks": np.concatenate([masks, p_masks.astype(bool)]) if len(masks) or len(p_masks) else masks,
        "boxes": np.concatenate([boxes, p_boxes]).astype(np.float32),
        "labels": np.concatenate([sample["labels"][keep], p_labels]),
    }
    return sanitize(out)


# ------------------------------------------------------------------ presets


def _multiscale_or_crop():
    return RandomChoice([
        RandomShortestSize(SCALES, 1333),
        Compose([
            RandomShortestSize([400, 500, 600]),
            RandomSizeCrop(384, 600),
            RandomShortestSize(SCALES, 1333),
        ]),
    ])


def _lsj(size):
    return Compose([
        ScaleJitter((size, size)),
        RandomCropPad((size, size)),
        RandomHorizontalFlip(0.5),
        Sanitize(),
    ])


PRESETS: Dict[str, Callable[[], Compose]] = {
    "basic": lambda: Compose([]),
    "hflip": lambda: Compose([RandomHorizontalFlip(0.5)]),
    "multiscale": lambda: Compose([RandomShortestSize(SCALES, 1333), RandomHorizontalFlip(0.5)]),
    "detr": lambda: Compose([RandomHorizontalFlip(0.5), _multiscale_or_crop(), Sanitize()]),
    "lsj": lambda: _lsj(1024),
    "lsj_1536": lambda: _lsj(1536),
    "ssd": lambda: Compose([
        RandomPhotometricDistort(), RandomZoomOut(), RandomIoUCrop(), RandomHorizontalFlip(0.5),
        Sanitize(),
    ]),
    "ssdlite": lambda: Compose([RandomIoUCrop(), RandomHorizontalFlip(0.5), Sanitize()]),
    "rtdetr": lambda: Compose([
        RandomPhotometricDistort(p=0.8), RandomZoomOut(fill=(0, 0, 0), p=0.5), RandomIoUCrop(),
        RandomHorizontalFlip(0.5), Resize((640, 640)), Sanitize(),
    ]),
    "mosaic": lambda: Compose([
        Mosaic((640, 640)), RandomShortestSize(SCALES, 1333), RandomHorizontalFlip(0.5), Sanitize(),
    ]),
    "mixup": lambda: Compose([MixUp(), RandomHorizontalFlip(0.5), _multiscale_or_crop(), Sanitize()]),
    "strong_album": lambda: Compose([
        RandomHorizontalFlip(0.5),
        _multiscale_or_crop(),
        # the reference's albumentations block
        RandomShift(0.0625, p=0.5),
        RandomBrightnessContrast(p=0.2),
        OneOf([RandomRGBShift(10), RandomHSV(20, 30, 20)], p=1.0),
        RandomJPEG((85, 95), p=0.2),
        RandomChannelShuffle(p=0.1),
        RandomBlur(p=0.1),
        RandomHorizontalFlip(0.5),
        RandomVerticalFlip(0.5),
        Sanitize(),
    ]),
}


def build_preset(name: str) -> Compose:
    """A fresh transform of the preset ``name``."""
    if name not in PRESETS:
        raise ValueError(f"unknown train_transform {name!r}; presets: {sorted(PRESETS)}")
    return PRESETS[name]()
