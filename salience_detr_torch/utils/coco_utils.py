"""COCO index of any dataset (the port's copy of
salience_detr_tpu/utils/coco_utils.py): ``convert_to_coco_api`` walks a
dataset of the port's sample dicts and builds a :class:`CocoIndex` the
evaluator can score, and ``get_coco_index_from_dataset`` returns a dataset's
own index where it has one."""

from __future__ import annotations

from typing import List

import numpy as np

from salience_detr_torch.data.coco import CocoIndex
from salience_detr_torch.utils.coco_eval import rle_encode


def convert_to_coco_api(dataset) -> CocoIndex:
    """A :class:`CocoIndex` of any indexable dataset of sample dicts
    (``image`` (H, W, 3), ``boxes`` xyxy absolute, ``labels``, optional
    ``area`` / ``iscrowd`` / ``masks`` / ``image_id`` / ``orig_size``), read
    through ``dataset.get_raw(i)`` (no augmentation) where it exists: boxes
    as xywh, the area falling back to the box's, masks RLE-encoded, the
    annotation ids from 1."""
    images: List[dict] = []
    annotations: List[dict] = []
    cat_ids = set()
    ann_id = 1
    fetch = getattr(dataset, "get_raw", None) or dataset.__getitem__
    for idx in range(len(dataset)):
        sample = fetch(idx)
        img_id = int(sample.get("image_id", idx))
        if "orig_size" in sample:
            h, w = (int(v) for v in sample["orig_size"])
        else:
            h, w = sample["image"].shape[:2]
        images.append({"id": img_id, "height": h, "width": w})

        boxes = np.asarray(sample["boxes"], np.float64).reshape(-1, 4)
        labels = np.asarray(sample["labels"]).reshape(-1)
        n = boxes.shape[0]
        xywh = boxes.copy()
        xywh[:, 2:] -= xywh[:, :2]
        areas = np.asarray(sample.get("area", xywh[:, 2] * xywh[:, 3]), np.float64).reshape(-1)
        iscrowd = np.asarray(sample.get("iscrowd", np.zeros(n)), np.int64).reshape(-1)
        masks = sample.get("masks")
        for i in range(n):
            ann = {
                "id": ann_id,
                "image_id": img_id,
                "category_id": int(labels[i]),
                "bbox": [float(v) for v in xywh[i]],
                "area": float(areas[i]),
                "iscrowd": int(iscrowd[i]),
            }
            if masks is not None:
                ann["segmentation"] = rle_encode(np.asarray(masks[i], bool))
            cat_ids.add(int(labels[i]))
            annotations.append(ann)
            ann_id += 1

    categories = [{"id": c, "name": str(c)} for c in sorted(cat_ids)]
    return CocoIndex({"images": images, "annotations": annotations, "categories": categories})


def get_coco_index_from_dataset(dataset) -> CocoIndex:
    """The dataset's COCO index, unwrapping Subset-style nesting; one made by
    :func:`convert_to_coco_api` when it has none."""
    for _ in range(10):
        if isinstance(getattr(dataset, "coco", None), CocoIndex):
            return dataset.coco
        inner = getattr(dataset, "dataset", None) or getattr(dataset, "_ds", None)
        if inner is None:
            break
        dataset = inner
    if isinstance(getattr(dataset, "coco", None), CocoIndex):
        return dataset.coco
    return convert_to_coco_api(dataset)
