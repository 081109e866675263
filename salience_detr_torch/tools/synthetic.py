"""The synthetic detection splits of the training-quality tools, without cv2.

Three generators, each drawing the same ``np.random.default_rng(seed)``
sequence as the JAX package's tool it follows, so a seed gives the same
scene:

* :func:`make_dataset` - coloured rectangles on noise, 128x128, 3 classes
  (``tools/validate_static_shapes.py`` ``make_dataset``);
* :func:`make_rich_dataset` - the campaign's scenes: a gradient and noise
  background, grey clutter, 2-12 objects of 16-640 px in 3 colours x
  {rectangle, ellipse} (``tools/quality_campaign_r5.py``
  ``make_rich_dataset``);
* :func:`make_defect_dataset` - 3 unseen colours with the sparse category
  ids 11/57/89 on the same kind of background, 256x320
  (``tools/finetune_rehearsal.py`` ``make_defect_dataset``).

The JAX tools draw with ``cv2.rectangle`` / ``cv2.ellipse`` and write a
quality-95 JPEG that their loader decodes; here the shapes are filled by
``data.cv_ops.fill_rect_into`` / ``fill_ellipse_into`` and each image is
saved as ``{i}.npy`` holding the RGB array that the JAX loader decodes from
its ``{i}.jpg`` (``data.cv_ops.jpeg_roundtrip_u8``), byte for byte.  The
annotation JSON equals the JAX one apart from the ``file_name`` extension.

A split is generated once per directory: a stamp file records the
generator, count, seed and canvas, and a call that finds a matching stamp
returns the paths without drawing again.

Imports numpy and the port only.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Tuple

import numpy as np

from salience_detr_torch.data.cv_ops import fill_ellipse_into, fill_rect_into, jpeg_roundtrip_u8

JPEG_QUALITY = 95  # cv2.imwrite's default

# the rectangles split
CANVAS = (128, 128)
NUM_CLASSES = 4  # 3 fg colours + background id 0 unused
COLORS = {1: (220, 40, 40), 2: (40, 220, 40), 3: (40, 40, 220)}

# the campaign's scenes
RICH_NUM_CLASSES = 7  # ids 1..6 used; 3 colours x 2 shapes
RICH_COLORS = {0: (225, 60, 50), 1: (60, 205, 70), 2: (65, 70, 220)}

# the fine-tune's defects
DEFECT_CANVAS = (256, 320)
DEFECT_IDS = (11, 57, 89)  # sparse non-COCO-contiguous category ids
DEFECT_COLORS = {11: (235, 215, 50), 57: (50, 220, 220), 89: (225, 60, 215)}

STAMP = ".generated.json"


class _Split:
    """Writes one split: each image's decoded RGB as ``{i}.npy`` on a pool
    of threads (the JPEG round trip is numpy over whole planes), then the
    annotations and the stamp."""

    def __init__(self, root: str, stamp: Dict):
        self.root, self.stamp = root, stamp
        self.img_dir = os.path.join(root, "imgs")
        self.ann_file = os.path.join(root, "ann.json")
        self.images: List[dict] = []
        self.annotations: List[dict] = []
        self._pool = None
        self._pending = []

    def done(self) -> bool:
        try:
            with open(os.path.join(self.root, STAMP)) as f:
                return json.load(f) == self.stamp and os.path.exists(self.ann_file)
        except (OSError, ValueError):
            return False

    def __enter__(self):
        os.makedirs(self.img_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
        return self

    def add_image(self, i: int, rgb: np.ndarray):
        """Image ``i``, whose true colours are ``rgb``, as the JAX loader
        decodes it from the JPEG; the images entry as the JAX tool writes
        it, with the ``.npy`` name."""
        path = os.path.join(self.img_dir, f"{i}.npy")
        self._pending.append(self._pool.submit(lambda: np.save(path, jpeg_roundtrip_u8(rgb, JPEG_QUALITY))))
        h, w = rgb.shape[:2]
        self.images.append({"id": i, "file_name": f"{i}.npy", "height": h, "width": w})

    def __exit__(self, exc_type, exc, tb):
        self._pool.shutdown(wait=True)
        for fut in self._pending:
            if exc_type is None:
                fut.result()
        if exc_type is None:
            with open(self.ann_file, "w") as f:
                json.dump({"images": self.images, "annotations": self.annotations,
                           "categories": self.stamp["categories"]}, f)
            with open(os.path.join(self.root, STAMP), "w") as f:
                json.dump(self.stamp, f)
        return False


def _generate(root: str, name: str, n_images: int, seed: int, canvas, categories,
              draw: Callable[[np.random.Generator, _Split, int], None]) -> Tuple[str, str]:
    split = _Split(root, {"generator": name, "n_images": int(n_images), "seed": int(seed),
                          "canvas": [int(v) for v in canvas], "categories": categories})
    if split.done():
        return split.img_dir, split.ann_file
    rng = np.random.default_rng(seed)
    with split:
        for i in range(n_images):
            draw(rng, split, i)
    return split.img_dir, split.ann_file


def make_dataset(root: str, n_images: int, seed: int) -> Tuple[str, str]:
    """Coloured rectangles on dark noise, 1-3 an image (the JAX tool fills
    them by numpy slices, which exclude the far edge, and writes the array
    as BGR); returns (image dir, annotation file)."""

    def draw(rng, split, i):
        h, w = CANVAS
        img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(1, NUM_CLASSES))
            bw, bh = rng.integers(18, 48, 2)
            x = int(rng.integers(0, w - bw))
            y = int(rng.integers(0, h - bh))
            img[y: y + bh, x: x + bw] = COLORS[cls]
            split.annotations.append({
                "id": len(split.annotations), "image_id": i, "category_id": cls,
                "bbox": [float(x), float(y), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
            })
        split.add_image(i, img[..., ::-1])

    return _generate(root, "rectangles", n_images, seed, CANVAS,
                     [{"id": c, "name": f"c{c}"} for c in COLORS], draw)


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def make_rich_dataset(root: str, n_images: int, seed: int, canvas) -> Tuple[str, str]:
    """Detectable but non-trivial scenes at ``canvas``: objects of 16-640 px
    (log-uniform, every salience level range), two shapes a colour,
    largest first with low-overlap placement, a gradient and noise
    background and grey clutter that is not annotated (the JAX tool writes
    the array as RGB); returns (image dir, annotation file)."""
    H, W = canvas
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    ramp_x, ramp_y = 30 * gx / W, 30 * gy / H

    def draw(rng, split, i):
        base = 40 + ramp_x * rng.uniform(-1, 1) + ramp_y * rng.uniform(-1, 1)
        img = np.clip(base[..., None] + rng.normal(0, 18, (H, W, 3)), 0, 95).astype(np.uint8)
        for _ in range(int(rng.integers(3, 9))):
            dw = int(rng.integers(20, min(160, W - 1)))
            dh = int(rng.integers(20, min(160, H - 1)))
            x = int(rng.integers(0, W - dw))
            y = int(rng.integers(0, H - dh))
            tone = int(rng.integers(70, 110))
            fill_rect_into(img, (x, y), (x + dw, y + dh), (tone, tone, tone))
        boxes = []
        sizes = np.exp(rng.uniform(np.log(16), np.log(640), int(rng.integers(2, 13))))
        for s in np.sort(sizes)[::-1]:
            ar = rng.uniform(0.5, 2.0)
            bw = float(np.clip(s * np.sqrt(ar), 12, W - 2))
            bh = float(np.clip(s / np.sqrt(ar), 12, H - 2))
            ok = False
            for _ in range(8):  # rejection-sample a low-overlap placement
                x = float(rng.uniform(0, W - bw))
                y = float(rng.uniform(0, H - bh))
                cand = np.array([x, y, x + bw, y + bh])
                if all(_iou(cand, b) < 0.3 for b in boxes):
                    ok = True
                    break
            if not ok:
                continue
            color_id = int(rng.integers(0, 3))
            shape_id = int(rng.integers(0, 2))
            color = RICH_COLORS[color_id]
            jitter = tuple(int(np.clip(c + rng.integers(-25, 26), 0, 255)) for c in color)
            x0, y0, x1, y1 = int(x), int(y), int(x + bw), int(y + bh)
            if shape_id == 0:
                fill_rect_into(img, (x0, y0), (x1, y1), jitter)
            else:
                fill_ellipse_into(img, ((x0 + x1) // 2, (y0 + y1) // 2),
                                  (max((x1 - x0) // 2, 1), max((y1 - y0) // 2, 1)), jitter)
            boxes.append(cand)
            split.annotations.append({
                "id": len(split.annotations), "image_id": i, "category_id": 1 + color_id * 2 + shape_id,
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
            })
        split.add_image(i, img)

    return _generate(root, "rich", n_images, seed, canvas,
                     [{"id": c, "name": f"c{c}"} for c in range(1, RICH_NUM_CLASSES)], draw)


def make_defect_dataset(root: str, n_images: int, seed: int) -> Tuple[str, str]:
    """3 unseen colours with the non-COCO ids 11/57/89 (rectangles and
    ellipses) over grey clutter and noise at 256x320 (the JAX tool writes
    the array as BGR); returns (image dir, annotation file)."""
    H, W = DEFECT_CANVAS

    def draw(rng, split, i):
        img = np.clip(rng.normal(55, 18, (H, W, 3)), 0, 95).astype(np.uint8)
        for _ in range(int(rng.integers(2, 7))):
            dw, dh = rng.integers(12, 60, 2)
            x = int(rng.integers(0, W - dw))
            y = int(rng.integers(0, H - dh))
            tone = int(rng.integers(70, 110))
            fill_rect_into(img, (x, y), (x + int(dw), y + int(dh)), (tone, tone, tone))
        for _ in range(int(rng.integers(1, 5))):
            cid = int(rng.choice(DEFECT_IDS))
            bw, bh = (int(v) for v in rng.integers(24, 90, 2))
            x = int(rng.integers(0, W - bw))
            y = int(rng.integers(0, H - bh))
            color = DEFECT_COLORS[cid]
            jitter = tuple(int(np.clip(c + rng.integers(-20, 21), 0, 255)) for c in color)
            if rng.random() < 0.5:
                fill_rect_into(img, (x, y), (x + bw, y + bh), jitter)
            else:
                fill_ellipse_into(img, (x + bw // 2, y + bh // 2), (bw // 2, bh // 2), jitter)
            split.annotations.append({
                "id": len(split.annotations), "image_id": i, "category_id": cid,
                "bbox": [float(x), float(y), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
            })
        split.add_image(i, img[..., ::-1])

    return _generate(root, "defects", n_images, seed, DEFECT_CANVAS,
                     [{"id": c, "name": f"defect_{c}"} for c in DEFECT_IDS], draw)
