"""COCO-format detection dataset, boxes only (the port's copy of
salience_detr_tpu/data/coco.py's ``CocoIndex``, ``_prepare_target``,
``CocoDetection`` with its transforms, and ``Object365Detection``).

The annotation index is built directly from the JSON, and the same index
feeds the evaluator (``utils/coco_eval.py``).  Images are decoded with cv2
(BGR -> RGB) where it is installed; ``.npy`` files holding uint8 HWC RGB
arrays are read with numpy everywhere.  A machine without cv2, as the CUDA
card's machine is, reads ``.npy`` images only.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional

import numpy as np

from salience_detr_torch.data.transforms import NOT_PORTED


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


def _prepare_target(img_h: int, img_w: int, anns: List[dict]) -> Dict[str, np.ndarray]:
    """COCO anns -> clamped xyxy boxes + labels, dropping degenerate boxes and
    crowd annotations (ConvertCocoPolysToMask semantics)."""
    anns = [a for a in anns if a.get("iscrowd", 0) == 0]
    boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
    # xywh -> xyxy, clamp to image
    boxes[:, 2:] += boxes[:, :2]
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, img_w)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, img_h)
    labels = np.asarray([a["category_id"] for a in anns], np.int64)
    area = np.asarray([a.get("area", 0.0) for a in anns], np.float32)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    return {"boxes": boxes[keep], "labels": labels[keep], "area": area[keep]}


def load_image(path: str) -> np.ndarray:
    """uint8 (H, W, 3) RGB: ``.npy`` with numpy, any other file with cv2."""
    if path.endswith(".npy"):
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
    image_id, orig_size), augmented by ``transforms(sample, rng)`` when
    given.  ``train`` drops the images without a valid annotation.  Mix
    transforms (``Mosaic``, ``MixUp``) are wired to draw their extra samples
    from this dataset without transforms."""

    def __init__(self, img_folder: str, ann_file: str, transforms: Optional[Callable] = None,
                 train: bool = False, return_masks: bool = False):
        if return_masks:
            raise ValueError(f"return_masks is not ported: it needs {NOT_PORTED['copypaste']}")
        self.img_folder = img_folder
        self.coco = CocoIndex(ann_file)
        self.transforms = transforms
        self.train = train
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
        target = _prepare_target(h, w, self.coco.annotations(img_id))
        return {
            "image": image,
            "boxes": target["boxes"],
            "labels": target["labels"],
            "area": target["area"],
            "image_id": img_id,
            "orig_size": np.asarray([h, w], np.int32),
        }

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
