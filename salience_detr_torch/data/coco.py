"""COCO-format detection dataset (the port's copy of
salience_detr_tpu/data/coco.py's ``CocoIndex``, ``_rasterize_mask``,
``_prepare_target``, ``CocoDetection`` with its transforms and instance
masks, ``Object365Detection`` and ``InferenceDataset``).

The annotation index is built directly from the JSON, and the same index
feeds the evaluator (``utils/coco_eval.py``).  Images are decoded with cv2
(BGR -> RGB) where it is installed; ``.npy`` files holding uint8 HWC RGB
arrays are read with numpy everywhere.  A machine without cv2, as the CUDA
card's machine is, reads ``.npy`` images only.  Polygon masks are filled
by ``cv_ops.fill_poly_into``, byte-equal to the JAX package's ``cv2.fillPoly``.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional

import numpy as np

from salience_detr_torch.data.cv_ops import fill_poly_into


class CocoIndex:
    """Minimal in-memory COCO annotation index (in place of pycocotools.COCO).

    Accepts an annotation-file path or an already-built COCO-format dict."""

    def __init__(self, ann_file):
        if isinstance(ann_file, dict):
            data = ann_file
        else:
            with open(ann_file) as f:
                data = json.load(f)
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for ann in data.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)
        self.img_ids = sorted(self.imgs)
        self.cat_ids = sorted(self.cats)

    def annotations(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])


def _rasterize_mask(img_h: int, img_w: int, segmentation) -> np.ndarray:
    """COCO polygon segmentation -> (img_h, img_w) bool mask: each polygon's
    vertices rounded half to even and filled (an RLE segmentation, crowd
    only, gives an empty mask)."""
    mask = np.zeros((img_h, img_w), np.uint8)
    if isinstance(segmentation, list):
        for poly in segmentation:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            fill_poly_into(mask, np.round(pts).astype(np.int32), 1)
    return mask.astype(bool)


def _prepare_target(img_h: int, img_w: int, anns: List[dict], return_masks: bool = False) -> Dict[str, np.ndarray]:
    """COCO anns -> clamped xyxy boxes + labels (and masks), dropping
    degenerate boxes and crowd annotations (ConvertCocoPolysToMask
    semantics)."""
    anns = [a for a in anns if a.get("iscrowd", 0) == 0]
    boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
    # xywh -> xyxy, clamp to image
    boxes[:, 2:] += boxes[:, :2]
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, img_w)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, img_h)
    labels = np.asarray([a["category_id"] for a in anns], np.int64)
    area = np.asarray([a.get("area", 0.0) for a in anns], np.float32)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    out = {"boxes": boxes[keep], "labels": labels[keep], "area": area[keep]}
    if return_masks:
        masks = np.stack(
            [_rasterize_mask(img_h, img_w, a.get("segmentation", [])) for a in anns]
        ) if anns else np.zeros((0, img_h, img_w), bool)
        out["masks"] = masks[keep]
    return out


def load_image(path: str) -> np.ndarray:
    """uint8 (H, W, 3) RGB: ``.npy`` with numpy, any other file with cv2."""
    if path.lower().endswith(".npy"):
        return np.load(path)
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"decoding {os.path.basename(path)} needs cv2, which is not installed") from e
    with open(path, "rb") as f:
        img = cv2.imdecode(np.frombuffer(f.read(), np.uint8), cv2.IMREAD_COLOR)  # BGR
    if img is None:
        raise ValueError(f"cannot decode {path}")
    return np.ascontiguousarray(img[:, :, ::-1])


class CocoDetection:
    """Map-style dataset of sample dicts (image, boxes, labels, area,
    image_id, orig_size, and with ``return_masks`` the (N, H, W) bool
    instance masks), augmented by ``transforms(sample, rng)`` when given.  ``train`` drops the images without a valid annotation.  Mix
    transforms (``Mosaic``, ``MixUp``) are wired to draw their extra samples
    from this dataset without transforms."""

    def __init__(self, img_folder: str, ann_file: str, transforms: Optional[Callable] = None,
                 train: bool = False, return_masks: bool = False):
        self.img_folder = img_folder
        self.coco = CocoIndex(ann_file)
        self.transforms = transforms
        self.train = train
        self.return_masks = return_masks
        self._wire_dataset(transforms)
        ids = list(self.coco.img_ids)
        if train:
            ids = [
                i
                for i in ids
                if len(_prepare_target(
                    self.coco.imgs[i].get("height", 1 << 30),
                    self.coco.imgs[i].get("width", 1 << 30),
                    self.coco.annotations(i),
                )["labels"]) > 0
            ]
        self.ids = ids

    def _wire_dataset(self, transform):
        if transform is None:
            return
        if hasattr(transform, "set_dataset"):
            transform.set_dataset(_PlainDataset(self))
        for child in getattr(transform, "transforms", []):
            self._wire_dataset(child)

    def __len__(self):
        return len(self.ids)

    def _image_file_name(self, info: dict) -> str:
        return info["file_name"]

    def get_raw(self, idx: int) -> dict:
        """The sample without transforms (thread-safe; mix transforms read it)."""
        img_id = self.ids[idx]
        image = load_image(os.path.join(self.img_folder, self._image_file_name(self.coco.imgs[img_id])))
        h, w = image.shape[:2]
        target = _prepare_target(h, w, self.coco.annotations(img_id), return_masks=self.return_masks)
        sample = {
            "image": image,
            "boxes": target["boxes"],
            "labels": target["labels"],
            "area": target["area"],
            "image_id": img_id,
            "orig_size": np.asarray([h, w], np.int32),
        }
        if self.return_masks:
            sample["masks"] = target["masks"]
        return sample

    def get_with_rng(self, idx: int, rng: random.Random) -> dict:
        """The sample, augmented with the caller's ``rng`` (the train loader
        derives it from the seed, the epoch and the index)."""
        sample = self.get_raw(idx)
        if self.transforms is not None:
            sample = self.transforms(sample, rng)
        return sample

    def __getitem__(self, idx: int) -> dict:
        return self.get_with_rng(idx, random.Random(random.getrandbits(64)))


class _PlainDataset:
    """The dataset without transforms (what mix transforms draw from)."""

    def __init__(self, ds: CocoDetection):
        self._ds = ds

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, idx):
        return self._ds.get_raw(idx)


class Object365Detection(CocoDetection):
    """Objects365: the file name's last two components under images/train or
    images/val, and a corrupt image skipped for the next one (up to 16)."""

    def _image_file_name(self, info: dict) -> str:
        parts = info["file_name"].replace("\\", "/").split("/")
        name = "/".join(parts[-2:]) if len(parts) >= 2 else parts[-1]
        split = "images/train" if self.train else "images/val"
        return os.path.join(split, name)

    def __getitem__(self, idx: int) -> dict:
        for attempt in range(16):
            try:
                return super().__getitem__((idx + attempt) % len(self))
            except Exception:
                continue
        raise RuntimeError(f"could not load any image near index {idx}")

    def get_with_rng(self, idx: int, rng: random.Random) -> dict:
        for attempt in range(16):
            try:
                return super().get_with_rng((idx + attempt) % len(self), rng)
            except Exception:
                continue
        raise RuntimeError(f"could not load any image near index {idx}")


class InferenceDataset:
    """A folder of images as samples (the JAX package's ``InferenceDataset``):
    the files with one of ``EXTS`` (any case), sorted by path, each sample
    the image (uint8 HWC RGB), no boxes or labels, its index as
    ``image_id``, its ``path`` and ``orig_size`` (h, w).  Image files are
    decoded with cv2, ``.npy`` files (uint8 HWC RGB arrays) with numpy, so a
    machine without cv2 reads a folder of ``.npy`` files."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".npy")

    def __init__(self, image_dir: str):
        self.paths = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir) if f.lower().endswith(self.EXTS)
        )

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        img = load_image(self.paths[idx])
        h, w = img.shape[:2]
        return {
            "image": img,
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int64),
            "image_id": idx,
            "path": self.paths[idx],
            "orig_size": np.asarray([h, w], np.int32),
        }
