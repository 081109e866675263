"""The port's evaluation path against the JAX package's, on the CPU.

* the COCO evaluator's copy (``utils/coco_eval.py``): the 12 stats within
  1e-12 and the per-category table equal to the JAX one's, crowd
  annotations included, through the host C++ matching and through numpy,
  and for the segm and keypoints protocols;
* the dataset's copy (``data/coco.py``): the same ids, images, boxes,
  labels, areas and original sizes, from ``.npy`` files and, where cv2 is
  installed, from PNG files;
* the eval loader: the JAX loader's orientation buckets and batch order,
  without its top-up duplicates; the prefetcher's batches and errors;
* the slice end to end on the tiny hybrid config, JAX variables exported
  into the port: the JAX ``make_eval_step`` and ``evaluate`` over its
  ``DetectionLoader`` against the port's, with the post-process filters off
  and on: per image the detections agree at rtol 1e-3 / atol 1e-3 (the
  full-model tolerance) with ``valid`` and labels equal, and the 12 stats
  within 1e-4.  The images have the eval geometry's sizes (96x128 and
  128x96 at min_size 96, max_size 128), so neither side resizes them; the
  fast lane runs landscape images only (one JAX compile a case), the slow
  lane both orientations.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.data.coco import CocoDetection as JaxCocoDetection
from salience_detr_tpu.data.coco import CocoIndex as JaxCocoIndex
from salience_detr_tpu.data.coco import _prepare_target as jax_prepare_target
from salience_detr_tpu.data.loader import DetectionLoader as JaxDetectionLoader
from salience_detr_tpu.data.loader import DevicePrefetcher as JaxDevicePrefetcher
from salience_detr_tpu.engine.train import evaluate as jax_evaluate
from salience_detr_tpu.models.bricks.post_process import PostProcess as JaxPostProcess
from salience_detr_tpu.models.detectors.salience_detr import normalize_images as jax_normalize_images
from salience_detr_tpu.parallel.train_step import TrainState
from salience_detr_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from salience_detr_tpu.utils import coco_eval as jax_coco_eval
from salience_detr_torch import native
from salience_detr_torch.data.coco import CocoDetection, CocoIndex
from salience_detr_torch.data.loader import DetectionLoader, DevicePrefetcher, to_device
from salience_detr_torch.engine.train import evaluate
from salience_detr_torch.models.bricks.post_process import PostProcess
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.parallel.train_step import make_eval_step
from salience_detr_torch.utils import coco_eval
from salience_detr_torch.weights import state_dict_from_jax
from tests.torch_port_common import CANVAS, TINY_TORCH, build_jax_tiny, jax_variable_shapes, random_variables

CATEGORIES = [{"id": c, "name": f"class{c}"} for c in range(5)]
# the tiny config's eval geometry, landscape and portrait
SIZES = [(96, 128), (128, 96), (96, 128), (96, 128), (128, 96)]


def random_annotations(rng, images, per_image=3):
    """Random xywh boxes inside each image, the last of every second image's
    a crowd annotation."""
    anns = []
    for img in images:
        h, w = img["height"], img["width"]
        for k in range(per_image):
            x, y = rng.uniform(0, 0.6 * w), rng.uniform(0, 0.6 * h)
            bw, bh = rng.uniform(4, 0.4 * w), rng.uniform(4, 0.4 * h)
            anns.append({"id": len(anns) + 1, "image_id": img["id"], "category_id": int(rng.integers(0, 5)),
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": int(k == per_image - 1 and img["id"] % 2 == 0)})
    return anns


def write_split(root, sizes, seed=0, fmt="npy", annotations=None):
    """A COCO-format split under ``root``: uint8 RGB images drawn from
    ``seed`` (the same pixels for every ``fmt``), saved as ``.npy`` or, with
    cv2, as lossless PNG, and an annotation file.  Returns (image dir,
    annotation path)."""
    rng = np.random.default_rng(seed)
    img_dir = root / f"images_{fmt}"
    img_dir.mkdir(parents=True, exist_ok=True)
    images = []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        name = f"{i:03d}.{fmt}"
        if fmt == "npy":
            np.save(img_dir / name, img)
        else:
            import cv2

            assert cv2.imwrite(str(img_dir / name), np.ascontiguousarray(img[:, :, ::-1]))
        images.append({"id": 10 + i, "file_name": name, "height": h, "width": w})
    anns = random_annotations(rng, images) if annotations is None else annotations
    ann = root / f"ann_{fmt}.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns, "categories": CATEGORIES}))
    return img_dir, ann


# ------------------------------------------------------------- evaluator


def evaluator_fixture(seed=0, with_masks=False):
    """A COCO dict with crowd, small and large gts, and predictions: the gts
    jittered (some with another label), false positives, and one image
    without predictions.  With ``with_masks``, gts carry polygon or RLE
    (raw and compressed) segmentations and keypoints, predictions masks and
    keypoints, all of one category (the keypoint protocol's person class:
    the evaluators read an image's keypoints only where it has a gt of the
    category)."""
    rng = np.random.default_rng(seed)
    H, W = 200, 300
    n_cats = 1 if with_masks else 3
    images = [{"id": i, "file_name": f"{i}.npy", "height": H, "width": W} for i in range(6)]
    anns = []
    for img in images:
        for k in range(4):
            bw, bh = rng.uniform(3, 150), rng.uniform(3, 150)
            x, y = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
            ann = {"id": len(anns) + 1, "image_id": img["id"], "category_id": int(rng.integers(0, n_cats)),
                   "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": int(k == 3 and img["id"] % 2 == 0)}
            if with_masks:
                x0, y0, x1, y1 = int(x), int(y), int(x + bw), int(y + bh)
                if ann["iscrowd"]:
                    mask = np.zeros((H, W), bool)
                    mask[y0:y1, x0:x1] = True
                    rle = jax_coco_eval.rle_encode(mask)
                    if img["id"] % 4 == 0:
                        rle["counts"] = jax_coco_eval.rle_string_encode(rle["counts"])
                    ann["segmentation"] = rle
                else:
                    ann["segmentation"] = [[x0, y0, x1, y0, x1, y1, x0, y1]]
                kps = np.zeros((17, 3))
                kps[:, 0], kps[:, 1] = rng.uniform(x, x + bw, 17), rng.uniform(y, y + bh, 17)
                kps[:, 2] = rng.integers(0, 3, 17)
                ann["keypoints"] = kps.reshape(-1).tolist()
            anns.append(ann)
    data = {"images": images, "annotations": anns, "categories": [{"id": c, "name": f"c{c}"} for c in range(n_cats)]}
    preds = {}
    for img in images[:-1]:
        gts = [a for a in anns if a["image_id"] == img["id"]]
        boxes, scores, labels, masks, kps = [], [], [], [], []
        for a in gts + [None, None]:
            if a is None:  # a false positive
                x, y, bw, bh = rng.uniform(0, 150), rng.uniform(0, 100), rng.uniform(3, 100), rng.uniform(3, 100)
                label = int(rng.integers(0, n_cats))
            else:
                x, y, bw, bh = np.asarray(a["bbox"]) + rng.normal(0, 1.5, 4)
                bw, bh = max(bw, 1.0), max(bh, 1.0)
                label = a["category_id"] if rng.uniform() < 0.8 else int(rng.integers(0, n_cats))
            boxes.append([x, y, x + bw, y + bh])
            scores.append(rng.uniform(0.05, 1.0))
            labels.append(label)
            mask = np.zeros((H, W), bool)
            mask[int(max(y, 0)):int(y + bh), int(max(x, 0)):int(x + bw)] = True
            masks.append(mask)
            k = np.zeros((17, 3))
            k[:, 0], k[:, 1], k[:, 2] = rng.uniform(x, x + bw, 17), rng.uniform(y, y + bh, 17), 1.0
            if a is not None and with_masks:  # near the gt's keypoints
                k[:, :2] = np.asarray(a["keypoints"]).reshape(17, 3)[:, :2] + rng.normal(0, 1.0, (17, 2))
            kps.append(k)
        preds[img["id"]] = {"boxes": np.asarray(boxes), "scores": np.asarray(scores), "labels": np.asarray(labels)}
        if with_masks:
            preds[img["id"]].update(masks=np.stack(masks), keypoints=np.stack(kps))
    return data, preds


def run_evaluator(module, index_cls, data, preds, **kw):
    ev = module.CocoEvaluator(index_cls(data), **kw)
    ev.update(preds)
    ev.synchronize_between_processes(lambda obj: [obj])
    ev.accumulate()
    return ev, ev.summarize()


@pytest.mark.parametrize("use_native", [True, False])
def test_evaluator_matches_jax(use_native):
    data, preds = evaluator_fixture()
    got_ev, got = run_evaluator(coco_eval, CocoIndex, data, preds, use_native=use_native)
    want_ev, want = run_evaluator(jax_coco_eval, JaxCocoIndex, data, preds, use_native=use_native)
    assert got_ev.route == ("native" if use_native else "numpy")
    if use_native:  # built under the ignored build/ directory, none in the package
        assert Path(native.cocoeval_lib()._name).parent.parent == native.BUILD_ROOT
        assert not list(Path(native.__file__).parent.rglob("*.so"))
    assert list(got) == coco_eval.METRIC_NAMES == list(want)
    assert all(abs(got[k] - want[k]) <= 1e-12 for k in want), (got, want)
    assert 0 < got["AP"] < 1 and got["ARs"] > -1 and got["APl"] > -1
    assert got_ev.per_category_table() == want_ev.per_category_table()


def test_evaluator_matches_jax_for_masks_and_keypoints():
    pytest.importorskip("cv2")  # polygon segmentations are rasterised with cv2
    data, preds = evaluator_fixture(seed=1, with_masks=True)
    types = ("bbox", "segm", "keypoints")
    got_ev, got = run_evaluator(coco_eval, CocoIndex, data, preds, iou_types=types)
    want_ev, want = run_evaluator(jax_coco_eval, JaxCocoIndex, data, preds, iou_types=types)
    assert list(got) == list(want) and len(got) == 12 + 12 + 10
    assert all(abs(got[k] - want[k]) <= 1e-12 for k in want), (got, want)
    assert got["segm_AP"] > 0 and got["keypoints_AP"] > 0
    assert got_ev.per_category_table() == want_ev.per_category_table()


# --------------------------------------------------------------- dataset


def dataset_annotations():
    """Per image: a box, a crowd box, a degenerate box and a box past the
    image's edge; the third image has only a crowd annotation."""
    anns = []
    for img_id in (10, 11):
        for bbox, crowd in (([5.5, 6.0, 20.0, 12.0], 0), ([1.0, 2.0, 30.0, 30.0], 1), ([8.0, 8.0, 0.0, 5.0], 0),
                            ([50.0, 40.0, 60.0, 70.0], 0)):
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": len(anns) % 5, "bbox": bbox,
                         "area": bbox[2] * bbox[3], "iscrowd": crowd})
    anns.append({"id": len(anns) + 1, "image_id": 12, "category_id": 1, "bbox": [3.0, 3.0, 9.0, 9.0],
                 "area": 81.0, "iscrowd": 1})
    return anns


def assert_same_sample(got, want):
    assert set(got) == set(want) == {"image", "boxes", "labels", "area", "image_id", "orig_size"}
    for key in ("image", "boxes", "labels", "area", "orig_size"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["image_id"] == want["image_id"]


@pytest.mark.parametrize("train", [False, True])
def test_dataset_matches_jax_on_npy_images(tmp_path, train):
    """``.npy`` images (the JAX dataset decodes with cv2 only): the index,
    ids and targets against the JAX index and ``_prepare_target``, the image
    against the saved array."""
    sizes = [(60, 80), (90, 70), (64, 64)]
    img_dir, ann = write_split(tmp_path, sizes, fmt="npy", annotations=dataset_annotations())
    got = CocoDetection(str(img_dir), str(ann), train=train)
    want = JaxCocoIndex(str(ann))
    for attr in ("dataset", "imgs", "cats", "img_to_anns", "img_ids", "cat_ids"):
        assert getattr(got.coco, attr) == getattr(want, attr), attr
    assert got.ids == ([10, 11] if train else [10, 11, 12])
    for idx, img_id in enumerate(got.ids):
        info = want.imgs[img_id]
        h, w = info["height"], info["width"]
        image = np.load(img_dir / info["file_name"])
        assert_same_sample(got[idx], {"image": image, "image_id": img_id, "orig_size": np.asarray([h, w], np.int32),
                                      **jax_prepare_target(h, w, want.annotations(img_id))})


@pytest.mark.parametrize("train", [False, True])
def test_dataset_matches_jax_on_png_images(tmp_path, train):
    pytest.importorskip("cv2")
    sizes = [(60, 80), (90, 70), (64, 64)]
    img_dir, ann = write_split(tmp_path, sizes, fmt="png", annotations=dataset_annotations())
    npy_dir, npy_ann = write_split(tmp_path, sizes, fmt="npy", annotations=dataset_annotations())
    want = JaxCocoDetection(str(img_dir), str(ann), train=train)
    got, got_npy = CocoDetection(str(img_dir), str(ann), train=train), CocoDetection(str(npy_dir), str(npy_ann), train=train)
    assert got.ids == want.ids == got_npy.ids
    for idx in range(len(want)):
        assert_same_sample(got[idx], want.get_raw(idx))
        assert_same_sample(got_npy[idx], want.get_raw(idx))


# ---------------------------------------------------------------- loader


def test_loader_batches_as_the_jax_loader_without_top_up(tmp_path):
    sizes = [(60, 80), (90, 70), (64, 64), (50, 90), (100, 40), (70, 70), (30, 60)]
    img_dir, ann = write_split(tmp_path, sizes)
    dataset = CocoDetection(str(img_dir), str(ann))
    want = [list(dict.fromkeys(b["image_ids"].tolist()))
            for b in JaxDetectionLoader(dataset, 3, max_gt=4, shuffle=False, drop_last=False, num_workers=2)]
    batches = list(DetectionLoader(dataset, 3, num_workers=2))
    assert [b["image_ids"].tolist() for b in batches] == want
    assert sorted(sum(want, [])) == sorted(dataset.ids)
    for b in batches:
        orient = {img.shape[1] >= img.shape[0] for img in b["images"]}
        assert len(orient) == 1
        np.testing.assert_array_equal(b["orig_sizes"], [img.shape[:2] for img in b["images"]])


def test_prefetcher_yields_device_batches_and_raises_loader_errors(tmp_path):
    img_dir, ann = write_split(tmp_path, SIZES)
    cfg = SalienceDETRConfig(**TINY_TORCH)
    loader = DetectionLoader(CocoDetection(str(img_dir), str(ann)), 2)
    got = list(DevicePrefetcher(loader, functools.partial(to_device, cfg=cfg), "cpu"))
    want = [to_device(b, cfg, torch.device("cpu")) for b in loader]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("images", "image_sizes", "orig_sizes"):
            torch.testing.assert_close(g[key], w[key], rtol=0, atol=0)
        np.testing.assert_array_equal(g["image_ids"], w["image_ids"])

    def failing():
        yield next(iter(loader))
        raise ValueError("broken image")

    seen = []
    with pytest.raises(ValueError, match="broken image"):
        for batch in DevicePrefetcher(failing(), functools.partial(to_device, cfg=cfg), "cpu"):
            seen.append(batch)
    assert len(seen) == 1


# ------------------------------------------------------- slice end to end


def port_run(model, cfg, img_dir, ann, post):
    """The port's eval loop; returns (stats, raw detections per image id)."""
    dataset = CocoDetection(str(img_dir), str(ann))
    step, recorded = make_eval_step(model, post, cfg.dtype), {}

    def recording(batch):
        dets = step(batch)
        for i, img_id in enumerate(batch["image_ids"]):
            recorded[int(img_id)] = {k: v[i].numpy() for k, v in dets.items()}
        return dets

    loader = DevicePrefetcher(DetectionLoader(dataset, 2), functools.partial(to_device, cfg=cfg), "cpu")
    return evaluate(recording, loader, coco_eval.CocoEvaluator(dataset.coco)), recorded


def jax_run(jmodel, jcfg, variables, img_dir, ann, post):
    """The JAX package's eval loop as its test.py runs it on one device."""
    dataset = JaxCocoDetection(str(img_dir), str(ann))
    loader = JaxDetectionLoader(
        dataset, 2, canvas_hw=CANVAS, max_gt=8, shuffle=False, drop_last=False, num_workers=1,
        eval_min_size=jcfg.min_size, eval_max_size=jcfg.max_size,
    )
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       frozen=variables.get("frozen", {}), batch_stats=variables.get("batch_stats", {}),
                       opt_state=None)
    step, recorded = jax_make_eval_step(jmodel, post), {}

    def recording(state, batch):
        dets = jax.device_get(step(state, batch))
        for i, img_id in enumerate(np.asarray(batch["image_ids"])):
            recorded.setdefault(int(img_id), {k: np.asarray(v[i]) for k, v in dets.items()})  # skip top-ups
        return dets

    def device_put(batch):
        batch = dict(batch)
        batch["images"] = jax_normalize_images(jnp.asarray(batch["images"], jnp.float32) / 255.0)
        return batch

    stats = jax_evaluate(recording, state, JaxDevicePrefetcher(loader, device_put),
                         jax_coco_eval.CocoEvaluator(dataset.coco))
    return stats, recorded


@pytest.fixture(scope="module")
def eval_models():
    """The tiny JAX model and its port with the same weights."""
    pytest.importorskip("cv2")  # the JAX dataset decodes images with cv2
    jcfg, tcfg, jmodel = build_jax_tiny()
    variables = random_variables(jax_variable_shapes(jmodel), seed=0)
    model, _ = build_salience_detr(tcfg, torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
    return jcfg, tcfg, jmodel, variables, model


def scored_split(root, sizes, model, cfg):
    """A split of ``sizes`` (as ``.npy`` and as PNG) whose gts are a first
    pass's detections, jittered, plus a crowd box and a missed gt, so that
    the metrics are not zero; and that pass's median score, the confidence
    threshold of the filtered case."""
    img_dir, ann = write_split(root, sizes)
    _, first = port_run(model, cfg, img_dir, ann, PostProcess(cfg.select_box_nums_for_evaluation))
    rng = np.random.default_rng(1)
    anns = []
    for img_id, det in sorted(first.items()):
        for box, label in zip(det["boxes"][:4], det["labels"][:4]):
            x0, y0, x1, y1 = np.asarray(box, np.float64) + rng.normal(0, 1.0, 4)
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": int(label),
                         "bbox": [x0, y0, max(x1 - x0, 2.0), max(y1 - y0, 2.0)], "area": 0.0, "iscrowd": 0})
        anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": 1, "bbox": [2.0, 3.0, 20.0, 15.0],
                     "area": 300.0, "iscrowd": int(img_id == 10)})
    for a in anns:
        a["area"] = a["area"] or a["bbox"][2] * a["bbox"][3]
    conf = float(np.round(np.median(np.concatenate([d["scores"] for d in first.values()])), 3))
    return {fmt: write_split(root, sizes, fmt=fmt, annotations=anns) for fmt in ("npy", "png")}, conf


# one canvas in the fast lane (one JAX compile a case); both orientations,
# one compile per canvas, in the slow lane
SPLITS = {"landscape": [(96, 128)] * 4, "mixed": SIZES}
SLICE_CASES = [
    pytest.param(split, filters, marks=[pytest.mark.slow] if split == "mixed" else [])
    for split in SPLITS for filters in ("off", "on")
]


@pytest.mark.parametrize("split,filters", SLICE_CASES)
def test_eval_slice_matches_jax(eval_models, tmp_path, split, filters):
    jcfg, tcfg, jmodel, variables, model = eval_models
    sizes = SPLITS[split]
    splits, conf = scored_split(tmp_path, sizes, model, tcfg)
    nms, conf = (-1.0, -1.0) if filters == "off" else (0.5, conf)
    k = tcfg.select_box_nums_for_evaluation
    want_stats, want = jax_run(jmodel, jcfg, variables, *splits["png"], JaxPostProcess(k, nms, conf))
    got_stats, got = port_run(model, tcfg, *splits["npy"], PostProcess(k, nms, conf))
    assert sorted(got) == sorted(want) == [10 + i for i in range(len(sizes))]
    for img_id in want:
        g, w = got[img_id], want[img_id]
        np.testing.assert_array_equal(g["valid"], w["valid"], err_msg=f"valid of image {img_id}")
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=f"labels of image {img_id}")
        for key in ("scores", "boxes"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-3, atol=1e-3, err_msg=f"{key} of image {img_id}")
    n_valid = sum(int(d["valid"].sum()) for d in got.values())
    assert n_valid == len(sizes) * k if filters == "off" else 0 < n_valid < len(sizes) * k
    assert list(got_stats) == list(want_stats) == coco_eval.METRIC_NAMES
    assert all(abs(got_stats[m] - want_stats[m]) <= 1e-4 for m in want_stats), (got_stats, want_stats)
    assert got_stats["AP50"] > 0.1
