"""COCO evaluation in numpy, in place of pycocotools (the port's copy of
salience_detr_tpu/utils/coco_eval.py).

The COCOeval protocol for the three iou types (bbox / segm / keypoints): IoU thresholds 0.50:0.05:0.95,
101 recall points, area ranges all/small/medium/large (keypoints:
all/medium/large with maxDets (20,) and OKS similarity), maxDets (1, 10,
100), crowd-aware greedy matching, and the standard metric summaries.
Segmentation masks ride as COCO run-length encodings — both raw run lists
and the pycocotools char-compressed string form decode here, so real COCO
annotation files (crowd RLEs) work without pycocotools.

The bbox matching of one (image, category, area range) runs in host C++
(``csrc/cocoeval.cpp``, built with g++ on first use by
:func:`salience_detr_torch.native.cocoeval_lib`) where g++ is installed, in
numpy otherwise; ``CocoEvaluator.route`` says which.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from salience_detr_torch.native import cocoeval_lib

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)

METRIC_NAMES = [
    "AP", "AP50", "AP75", "APs", "APm", "APl",
    "AR1", "AR10", "AR100", "ARs", "ARm", "ARl",
]

# Keypoint evaluation uses its own protocol constants (COCOeval
# Params.setKpParams): maxDets (20,), area ranges without "small", and the
# published per-keypoint OKS sigmas for the 17 COCO person keypoints.
KP_AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
KP_MAX_DETS = (20,)
KP_METRIC_NAMES = [
    "AP", "AP50", "AP75", "APm", "APl",
    "AR", "AR50", "AR75", "ARm", "ARl",
]
KPT_OKS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]
) / 10.0


def box_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix between xywh detections (D,4) and gts (G,4); crowd gts use
    intersection-over-detection-area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx0, dy0 = dt[:, 0], dt[:, 1]
    dx1, dy1 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.clip(
        np.minimum(dx1[:, None], gx1[None]) - np.maximum(dx0[:, None], gx0[None]), 0, None
    )
    iy = np.clip(
        np.minimum(dy1[:, None], gy1[None]) - np.maximum(dy0[:, None], gy0[None]), 0, None
    )
    inter = ix * iy
    darea = (dt[:, 2] * dt[:, 3])[:, None]
    garea = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), darea, darea + garea - inter)
    return inter / np.maximum(union, 1e-12)


# ------------------------------------------------------------------ RLE masks
#
# COCO-compatible run-length encoding: runs over the column-major (Fortran)
# flattening, first run counting zeros.  Annotation files carry either raw
# integer run lists or the pycocotools char-compressed string form (base-32
# chunks with a continuation bit, offset 48, runs from index 2 on delta-coded
# against counts[i-2]); both are handled here so crowd annotations from real
# COCO jsons decode without pycocotools.


def rle_encode(mask: np.ndarray) -> dict:
    """Binary (h, w) mask -> uncompressed RLE dict {"size", "counts"}."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).reshape(-1, order="F")
    if flat.size == 0:
        return {"size": [int(h), int(w)], "counts": [0]}
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]]))
    counts = [int(c) for c in runs]
    if flat[0]:
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": counts}


def _rle_counts(rle) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = rle_string_decode(counts)
    return list(counts)


def rle_decode(rle) -> np.ndarray:
    """RLE dict (raw-list or compressed-string counts) -> bool (h, w) mask."""
    h, w = rle["size"]
    counts = _rle_counts(rle)
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape((h, w), order="F")


def rle_area(rle) -> int:
    return int(sum(_rle_counts(rle)[1::2]))


def rle_string_decode(s) -> List[int]:
    """pycocotools rleFrString: char string -> run counts."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_string_encode(counts: Sequence[int]) -> str:
    """pycocotools rleToString: run counts -> char string."""
    out = []
    counts = list(counts)
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = (x != -1) if (chunk & 0x10) else (x != 0)
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
    return "".join(out)


def mask_iou(dt_masks: np.ndarray, gt_masks: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix between bool masks (D,h,w) and (G,h,w); crowd gts use
    intersection-over-detection-area (pycocotools rleIou semantics)."""
    D, G = len(dt_masks), len(gt_masks)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    dt_flat = np.asarray(dt_masks, bool).reshape(D, -1)
    gt_flat = np.asarray(gt_masks, bool).reshape(G, -1)
    inter = dt_flat.astype(np.float64) @ gt_flat.astype(np.float64).T  # (D, G)
    darea = dt_flat.sum(-1, dtype=np.float64)[:, None]
    garea = gt_flat.sum(-1, dtype=np.float64)[None]
    union = np.where(np.asarray(iscrowd, bool)[None], darea, darea + garea - inter)
    return inter / np.maximum(union, 1e-12)


def oks_matrix(
    dt_kps: np.ndarray,  # (D, K, 3) x, y, score
    gt_kps: np.ndarray,  # (G, K, 3) x, y, visibility
    gt_areas: np.ndarray,  # (G,)
    gt_boxes: np.ndarray,  # (G, 4) xywh
    sigmas: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Object-keypoint-similarity matrix (COCOeval computeOks): per-gt
    Gaussian falloff of keypoint distances normalized by object scale and
    per-keypoint sigma; gts with no labeled keypoints fall back to distances
    outside the doubled gt box."""
    if sigmas is None:
        sigmas = KPT_OKS_SIGMAS
    D, G = len(dt_kps), len(gt_kps)
    out = np.zeros((D, G))
    if D == 0 or G == 0:
        return out
    variances = (np.asarray(sigmas, np.float64) * 2.0) ** 2
    for g in range(G):
        xg, yg, vg = gt_kps[g, :, 0], gt_kps[g, :, 1], gt_kps[g, :, 2]
        k1 = int((vg > 0).sum())
        bb = gt_boxes[g]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for d in range(D):
            xd, yd = dt_kps[d, :, 0], dt_kps[d, :, 1]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                dx = np.maximum(x0 - xd, 0) + np.maximum(xd - x1, 0)
                dy = np.maximum(y0 - yd, 0) + np.maximum(yd - y1, 0)
            e = (dx**2 + dy**2) / variances / (gt_areas[g] + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            out[d, g] = np.exp(-e).sum() / len(e) if len(e) else 0.0
    return out


def _gt_mask(ann: dict, img_h: int, img_w: int) -> np.ndarray:
    """Annotation segmentation (polygon list or RLE dict) -> bool mask."""
    seg = ann.get("segmentation")
    if isinstance(seg, dict):
        return rle_decode(seg)
    if isinstance(seg, list) and seg:
        import cv2

        mask = np.zeros((img_h, img_w), np.uint8)
        for poly in seg:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
        return mask.astype(bool)
    return np.zeros((img_h, img_w), bool)


class CocoEvaluator:
    """Incremental evaluator: update() with per-image predictions, then
    accumulate()/summarize()."""

    def __init__(self, coco_index, iou_types: Sequence[str] = ("bbox",), use_native: bool = True):
        self.iou_types = list(iou_types)
        bad = set(self.iou_types) - {"bbox", "segm", "keypoints"}
        if bad:
            raise ValueError(f"unsupported iou types {sorted(bad)}")
        self.coco = coco_index
        self.cat_ids = list(coco_index.cat_ids)
        self.kp_sigmas = KPT_OKS_SIGMAS
        self.predictions: Dict[int, dict] = {}
        self.img_ids: List[int] = []
        self._native = None
        if use_native:
            try:
                self._native = cocoeval_lib()
            except (OSError, subprocess.CalledProcessError):  # no g++, or it failed
                self._native = None
        # the bbox matching's route: host C++ or numpy
        self.route = "native" if self._native is not None else "numpy"

    def update(self, predictions: Dict[int, dict]):
        """predictions: {image_id: {"boxes" (N,4 xyxy), "scores", "labels"}}
        plus, per enabled iou type, "masks" (N,h,w bool or N,1,h,w float
        logits>0.5, stored RLE-compressed like the reference's
        prepare_for_coco_segmentation) and/or "keypoints" (N,K,3)."""
        for img_id, pred in predictions.items():
            self.img_ids.append(img_id)
            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
            xywh = boxes.copy()
            xywh[:, 2:] -= xywh[:, :2]
            entry = {
                "boxes": xywh,
                "scores": np.asarray(pred["scores"], np.float64),
                "labels": np.asarray(pred["labels"], np.int64),
            }
            if "masks" in pred:
                masks = np.asarray(pred["masks"])
                if masks.ndim == 4:  # (N, 1, h, w) soft masks
                    masks = masks[:, 0] > 0.5
                entry["rles"] = [rle_encode(m) for m in masks.astype(bool)]
            if "keypoints" in pred:
                entry["keypoints"] = np.asarray(
                    pred["keypoints"], np.float64
                ).reshape(len(entry["scores"]), -1, 3)
            self.predictions[img_id] = entry

    def synchronize_between_processes(self, all_gather_fn: Optional[Callable] = None):
        """Merge the predictions of all processes through
        ``all_gather_fn(obj) -> list[obj]``; without one (a single process)
        there is nothing to merge."""
        if all_gather_fn is None:
            return
        merged = all_gather_fn(self.predictions)
        out = {}
        for d in merged:
            out.update(d)
        self.predictions = out
        self.img_ids = list(out.keys())

    # ------------------------------------------------------------ evaluation

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det, iou_type="bbox"):
        anns = [a for a in self.coco.annotations(img_id) if a["category_id"] == cat_id]
        gt_boxes = np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4)
        gt_crowd = np.asarray([a.get("iscrowd", 0) for a in anns], np.int64)
        gt_area = np.asarray(
            [a.get("area", b[2] * b[3]) for a, b in zip(anns, gt_boxes)], np.float64
        )
        pred = self.predictions.get(
            img_id, {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "labels": np.zeros(0, np.int64)}
        )
        sel = pred["labels"] == cat_id
        dt_boxes = pred["boxes"][sel]
        dt_scores = pred["scores"][sel]
        if len(gt_boxes) == 0 and len(dt_boxes) == 0:
            return None

        gt_ignore = gt_crowd.astype(bool) | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
        if iou_type == "keypoints":
            gt_kps_all = np.asarray(
                [a.get("keypoints", [0.0] * 51) for a in anns], np.float64
            ).reshape(len(anns), -1, 3)
            # gts with no labeled keypoints are always ignored (COCOeval
            # _prepare: gt['ignore'] |= k1 == 0)
            gt_ignore = gt_ignore | ((gt_kps_all[:, :, 2] > 0).sum(-1) == 0)
        # sort gts: non-ignored first (stable)
        g_order = np.argsort(gt_ignore, kind="stable")
        gt_boxes = gt_boxes[g_order]
        gt_crowd_s = gt_crowd[g_order]
        gt_ignore = gt_ignore[g_order]

        d_order = np.argsort(-dt_scores, kind="stable")[:max_det]
        dt_boxes = dt_boxes[d_order]
        dt_scores = dt_scores[d_order]

        T = len(IOU_THRS)
        D = len(dt_boxes)
        G = len(gt_boxes)

        if iou_type == "bbox":
            ious = None  # native fast path or box_iou below
            dt_area = dt_boxes[:, 2] * dt_boxes[:, 3]
        elif iou_type == "segm":
            img = self.coco.imgs[img_id]
            h, w = int(img["height"]), int(img["width"])
            gt_masks = np.stack(
                [_gt_mask(anns[i], h, w) for i in g_order], 0
            ) if G else np.zeros((0, h, w), bool)
            dt_rles_all = pred.get("rles", [])
            dt_rles = [dt_rles_all[i] for i in np.flatnonzero(sel)[d_order]]
            dt_masks = (
                np.stack([rle_decode(r) for r in dt_rles], 0)
                if dt_rles else np.zeros((0, h, w), bool)
            )
            ious = mask_iou(dt_masks, gt_masks, gt_crowd_s)
            dt_area = np.asarray([rle_area(r) for r in dt_rles], np.float64)
        elif iou_type == "keypoints":
            gt_kps = gt_kps_all[g_order]
            dt_kps_all = pred.get("keypoints", np.zeros((0, 17, 3)))
            dt_kps = dt_kps_all[sel][d_order]
            gt_area_s = gt_area[g_order]
            ious = oks_matrix(dt_kps, gt_kps, gt_area_s, gt_boxes, self.kp_sigmas)
            # detection "area" for range filtering: keypoint-extent box
            # (COCO.loadRes keypoint path)
            if len(dt_kps):
                x0 = dt_kps[:, :, 0].min(-1); x1 = dt_kps[:, :, 0].max(-1)
                y0 = dt_kps[:, :, 1].min(-1); y1 = dt_kps[:, :, 1].max(-1)
                dt_area = (x1 - x0) * (y1 - y0)
            else:
                dt_area = np.zeros(0)
        else:  # pragma: no cover
            raise ValueError(iou_type)

        if iou_type == "bbox" and self._native is not None and D > 0:
            import ctypes as ct

            dt_c = np.ascontiguousarray(dt_boxes, np.float64)
            gt_c = np.ascontiguousarray(gt_boxes, np.float64)
            crowd_c = np.ascontiguousarray(gt_crowd_s != 0, np.uint8)
            ign_c = np.ascontiguousarray(gt_ignore, np.uint8)
            thrs_c = np.ascontiguousarray(IOU_THRS, np.float64)
            matched = np.zeros((T, D), np.uint8)
            ignored = np.zeros((T, D), np.uint8)
            p64 = lambda a: a.ctypes.data_as(ct.POINTER(ct.c_double))
            p8 = lambda a: a.ctypes.data_as(ct.POINTER(ct.c_uint8))
            self._native.evaluate_img(
                p64(dt_c), D, p64(gt_c), G, p8(crowd_c), p8(ign_c),
                p64(thrs_c), T, float(area_rng[0]), float(area_rng[1]),
                p8(matched), p8(ignored),
            )
            return {
                "dt_scores": dt_scores,
                "dt_matched": matched.astype(bool),
                "dt_ignore": ignored.astype(bool),
                "num_gt": int((~gt_ignore).sum()),
            }

        if ious is None:
            ious = box_iou_xywh(dt_boxes, gt_boxes, gt_crowd_s)
        dt_match = np.zeros((T, D), np.int64) - 1
        gt_match = np.zeros((T, G), np.int64) - 1
        for t, thr in enumerate(IOU_THRS):
            for d in range(D):
                best = -1
                best_iou = min(thr, 1 - 1e-10)
                for g in range(G):
                    if gt_match[t, g] >= 0 and not gt_crowd_s[g]:
                        continue
                    # gts are sorted non-ignored first: once we have a match to
                    # a real gt, stop when reaching ignored ones
                    if best >= 0 and not gt_ignore[best] and gt_ignore[g]:
                        break
                    if ious[d, g] < best_iou:
                        continue
                    best_iou = ious[d, g]
                    best = g
                if best >= 0:
                    dt_match[t, d] = best
                    gt_match[t, best] = d

        dt_out_of_range = (dt_area < area_rng[0]) | (dt_area > area_rng[1])
        dt_ignore = np.zeros((T, D), bool)
        for t in range(T):
            matched = dt_match[t] >= 0
            ign_of_match = np.zeros(D, bool)
            ign_of_match[matched] = gt_ignore[dt_match[t][matched]]
            dt_ignore[t] = ign_of_match | (~matched & dt_out_of_range)

        return {
            "dt_scores": dt_scores,
            "dt_matched": dt_match >= 0,
            "dt_ignore": dt_ignore,
            "num_gt": int((~gt_ignore).sum()),
        }

    def accumulate(self):
        self._acc = {}
        for iou_type in self.iou_types:
            self._acc[iou_type] = self._accumulate_type(iou_type)
        primary = self._acc[self.iou_types[0]]
        self.precision = primary["precision"]
        self.recall = primary["recall"]
        self.scores = primary["scores"]

    def _accumulate_type(self, iou_type: str) -> dict:
        img_ids = sorted(set(self.img_ids) & set(self.coco.img_ids)) or sorted(
            set(self.coco.img_ids)
        )
        area_ranges = KP_AREA_RANGES if iou_type == "keypoints" else AREA_RANGES
        max_dets = KP_MAX_DETS if iou_type == "keypoints" else MAX_DETS
        K = len(self.cat_ids)
        A = len(area_ranges)
        M = len(max_dets)
        T = len(IOU_THRS)
        R = len(REC_THRS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        out_scores = -np.ones((T, R, K, A, M))

        for k, cat_id in enumerate(self.cat_ids):
            for a, area_rng in enumerate(area_ranges.values()):
                per_img = [
                    self._evaluate_img(i, cat_id, area_rng, max(max_dets), iou_type)
                    for i in img_ids
                ]
                for m, max_det in enumerate(max_dets):
                    results = []
                    num_gt = 0
                    for r in per_img:
                        if r is None:
                            continue
                        num_gt += r["num_gt"]
                        results.append(
                            (r["dt_scores"][:max_det], r["dt_matched"][:, :max_det],
                             r["dt_ignore"][:, :max_det])
                        )
                    if num_gt == 0:
                        continue
                    if results:
                        scores = np.concatenate([x[0] for x in results])
                        matched = np.concatenate([x[1] for x in results], axis=1)
                        ignored = np.concatenate([x[2] for x in results], axis=1)
                    else:
                        scores = np.zeros(0)
                        matched = np.zeros((T, 0), bool)
                        ignored = np.zeros((T, 0), bool)
                    order = np.argsort(-scores, kind="mergesort")
                    scores = scores[order]
                    matched = matched[:, order]
                    ignored = ignored[:, order]

                    tp = np.cumsum(matched & ~ignored, axis=1).astype(np.float64)
                    fp = np.cumsum(~matched & ~ignored, axis=1).astype(np.float64)
                    for t in range(T):
                        tp_t, fp_t = tp[t], fp[t]
                        rc = tp_t / num_gt
                        pr = tp_t / np.maximum(tp_t + fp_t, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        # monotone precision envelope from the right
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        s = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                                s[ri] = scores[pi]
                        precision[t, :, k, a, m] = q
                        out_scores[t, :, k, a, m] = s
        return {
            "precision": precision,
            "recall": recall,
            "scores": out_scores,
            "area_ranges": area_ranges,
            "max_dets": max_dets,
        }

    # ------------------------------------------------------------- summaries

    def _summarize(
        self, ap: bool, iou_thr: Optional[float], area: str, max_det: int,
        iou_type: Optional[str] = None,
    ):
        acc = self._acc[iou_type or self.iou_types[0]]
        a = list(acc["area_ranges"]).index(area)
        m = list(acc["max_dets"]).index(max_det)
        if ap:
            s = acc["precision"][:, :, :, a, m]
            if iou_thr is not None:
                s = s[[np.argmin(np.abs(IOU_THRS - iou_thr))]]
        else:
            s = acc["recall"][:, :, a, m]
            if iou_thr is not None:
                s = s[[np.argmin(np.abs(IOU_THRS - iou_thr))]]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def _summarize_type(self, iou_type: str) -> Dict[str, float]:
        if iou_type == "keypoints":
            md = KP_MAX_DETS[0]
            return {
                "AP": self._summarize(True, None, "all", md, iou_type),
                "AP50": self._summarize(True, 0.5, "all", md, iou_type),
                "AP75": self._summarize(True, 0.75, "all", md, iou_type),
                "APm": self._summarize(True, None, "medium", md, iou_type),
                "APl": self._summarize(True, None, "large", md, iou_type),
                "AR": self._summarize(False, None, "all", md, iou_type),
                "AR50": self._summarize(False, 0.5, "all", md, iou_type),
                "AR75": self._summarize(False, 0.75, "all", md, iou_type),
                "ARm": self._summarize(False, None, "medium", md, iou_type),
                "ARl": self._summarize(False, None, "large", md, iou_type),
            }
        return {
            "AP": self._summarize(True, None, "all", 100, iou_type),
            "AP50": self._summarize(True, 0.5, "all", 100, iou_type),
            "AP75": self._summarize(True, 0.75, "all", 100, iou_type),
            "APs": self._summarize(True, None, "small", 100, iou_type),
            "APm": self._summarize(True, None, "medium", 100, iou_type),
            "APl": self._summarize(True, None, "large", 100, iou_type),
            "AR1": self._summarize(False, None, "all", 1, iou_type),
            "AR10": self._summarize(False, None, "all", 10, iou_type),
            "AR100": self._summarize(False, None, "all", 100, iou_type),
            "ARs": self._summarize(False, None, "small", 100, iou_type),
            "ARm": self._summarize(False, None, "medium", 100, iou_type),
            "ARl": self._summarize(False, None, "large", 100, iou_type),
        }

    def summarize(self) -> Dict[str, float]:
        """Flat metric dict for the primary iou type; additional types are
        namespaced (e.g. "segm_AP") so existing single-type callers keep the
        reference's 12-metric layout."""
        stats = dict(self._summarize_type(self.iou_types[0]))
        for iou_type in self.iou_types[1:]:
            for k, v in self._summarize_type(iou_type).items():
                stats[f"{iou_type}_{k}"] = v
        return stats

    def per_category_table(self) -> str:
        """Per-category AP/AR100 table (the reference prints an AsciiTable)."""
        acc = self._acc[self.iou_types[0]]
        m = len(acc["max_dets"]) - 1  # largest maxDet (100 bbox/segm, 20 kp)
        rows = []
        for k, cat_id in enumerate(self.cat_ids):
            p = acc["precision"][:, :, k, 0, m]
            r = acc["recall"][:, k, 0, m]
            ap = float(np.mean(p[p > -1])) if (p > -1).any() else float("nan")
            ar = float(np.mean(r[r > -1])) if (r > -1).any() else float("nan")
            name = self.coco.cats.get(cat_id, {}).get("name", str(cat_id))
            rows.append((name, ap, ar))
        width = max((len(r[0]) for r in rows), default=8)
        lines = [f"{'category':<{width}}  {'AP':>7}  {'AR100':>7}"]
        for name, ap, ar in rows:
            lines.append(f"{name:<{width}}  {ap:7.3f}  {ar:7.3f}")
        return "\n".join(lines)
