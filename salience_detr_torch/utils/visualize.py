"""Box drawing (port of salience_detr_tpu/utils/visualize.py): the same
palette, score threshold, label text and colours, drawn by cv2.

Hershey text with anti-aliased lines has no cv2-free counterpart that gives
the same pixels, so drawing needs cv2; it is imported when a function runs,
and where it is missing (the CUDA card's machine has none) the functions
raise an error that names it.  Nothing else of the port needs cv2 to draw."""

from __future__ import annotations

import colorsys
import os
from typing import Dict, Optional, Sequence

import numpy as np


def require_cv2():
    """The cv2 module, or a RuntimeError that names it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("drawing boxes needs cv2 (opencv-python), which is not installed") from e
    return cv2


def drawing_name(path: str) -> str:
    """The file name a drawing of the image at ``path`` is written under:
    its own, a ``.npy`` array's as ``.png``."""
    name = os.path.basename(path)
    return name[:-4] + ".png" if name.lower().endswith(".npy") else name


def _palette(n: int):
    return [
        tuple(int(c * 255) for c in colorsys.hsv_to_rgb(i / max(n, 1), 0.8, 0.95))
        for i in range(n)
    ]


def plot_bounding_boxes_on_image(
    image: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    score_threshold: float = 0.3,
    thickness: int = 2,
) -> np.ndarray:
    """A copy of the RGB uint8 ``image`` with the xyxy ``boxes`` drawn, each
    in its label's palette colour with a filled tag of its class name (or
    label) and score; boxes scoring under ``score_threshold`` are skipped."""
    cv2 = require_cv2()
    img = np.array(image, copy=True)
    boxes, labels = np.asarray(boxes), np.asarray(labels)
    n_classes = int(labels.max()) + 1 if len(labels) else 1
    colors = _palette(max(n_classes, 8))
    for i in range(len(boxes)):
        if scores is not None and scores[i] < score_threshold:
            continue
        x0, y0, x1, y1 = (int(v) for v in boxes[i])
        c = colors[int(labels[i]) % len(colors)]
        cv2.rectangle(img, (x0, y0), (x1, y1), c, thickness)
        name = (
            class_names[int(labels[i])]
            if class_names and int(labels[i]) < len(class_names)
            else str(int(labels[i]))
        )
        text = f"{name}" + (f" {scores[i]:.2f}" if scores is not None else "")
        (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(img, (x0, y0 - th - 4), (x0 + tw + 2, y0), c, -1)
        cv2.putText(img, text, (x0 + 1, y0 - 3), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1, cv2.LINE_AA)
    return img


def save_visualization(image: np.ndarray, prediction: Dict[str, np.ndarray], out_path: str, **kw):
    """Draw ``prediction`` (boxes, labels, optional scores) on ``image`` and
    write it to ``out_path`` (its extension picks the format)."""
    cv2 = require_cv2()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    img = plot_bounding_boxes_on_image(
        image, prediction["boxes"], prediction["labels"], prediction.get("scores"), **kw,
    )
    if not cv2.imwrite(out_path, np.ascontiguousarray(img[:, :, ::-1])):
        raise OSError(f"cv2 could not write {out_path}")
