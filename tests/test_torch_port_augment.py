"""The train path's cv2 options in the port against the JAX package: each
albumentations-style transform and the whole ``strong_album`` preset give
byte-equal images, equal boxes and labels for the same sample and
``random.Random(seed)``; instance masks go through flips, resize, crop,
sanitize and RandomIoUCrop as in the JAX functions; ``simple_copy_paste``
gives equal boxes, labels and masks, and images within one level only
where the JAX blend lands within 1e-4 of an integer before its cast;
``CocoDetection(return_masks=True)`` fills a written polygon split as the
JAX dataset does; and the train CLI trains with ``strong_album`` plus
``copypaste`` on the CPU with cv2 blocked from import."""

import random
import sys

import numpy as np
import pytest

from salience_detr_tpu.data import transforms as jt
from salience_detr_tpu.data.coco import CocoDetection as JaxCocoDetection
from salience_detr_torch import train
from salience_detr_torch.data import transforms as pt
from salience_detr_torch.data.coco import CocoDetection
from tests.test_torch_port_train_cli import cli, write_config
from tests.test_torch_port_transforms import assert_same, make_sample
from tests.torch_port_common import TINY_TORCH, write_coco_split
from tests.torch_port_common import two_torch_threads  # noqa: F401

cv2 = pytest.importorskip("cv2")

SIZES = [(61, 47), (130, 70), (3, 5), (240, 320)]
SEEDS = range(6)


def mask_sample(rng, h, w, n):
    """A sample whose n instances are filled random polygons, boxes from
    their masks (some instances empty)."""
    masks = np.zeros((n, h, w), bool)
    for i in range(n):
        pts = np.stack([rng.integers(-3, w + 3, 6), rng.integers(-3, h + 3, 6)], 1).astype(np.int32)
        masks[i] = cv2.fillPoly(np.zeros((h, w), np.uint8), [pts], 1) > 0
    boxes = np.zeros((n, 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(xs):
            boxes[i] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    sample = make_sample(rng, h, w, n)
    return {**sample, "boxes": boxes, "masks": masks}


def assert_same_masks(got, want):
    assert_same(got, want)
    if "masks" in want:
        assert got["masks"].shape == want["masks"].shape
        np.testing.assert_array_equal(np.asarray(got["masks"]).astype(bool), np.asarray(want["masks"]).astype(bool))


NEW_TRANSFORMS = {
    "shift": lambda m: m.RandomShift(0.0625, p=1.0),
    "brightness_contrast": lambda m: m.RandomBrightnessContrast(p=1.0),
    "rgb_shift": lambda m: m.RandomRGBShift(10),
    "hsv": lambda m: m.RandomHSV(20, 30, 20),
    "jpeg": lambda m: m.RandomJPEG((85, 95), p=1.0),
    "channel_shuffle": lambda m: m.RandomChannelShuffle(p=1.0),
    "blur": lambda m: m.RandomBlur(p=1.0),
    "vflip": lambda m: m.RandomVerticalFlip(1.0),
    "one_of": lambda m: m.OneOf([m.RandomRGBShift(10), m.RandomHSV(20, 30, 20)], p=1.0),
}


@pytest.mark.parametrize("name", sorted(NEW_TRANSFORMS))
def test_new_transforms_equal_jax(name):
    jax_t, port_t = NEW_TRANSFORMS[name](jt), NEW_TRANSFORMS[name](pt)
    for seed in SEEDS:
        for h, w in SIZES:
            sample = mask_sample(np.random.default_rng([seed, h, w]), h, w, 3)
            assert_same_masks(port_t(sample, random.Random(seed)), jax_t(sample, random.Random(seed)))


@pytest.mark.parametrize("seed", range(8))
def test_strong_album_preset_with_masks(seed):
    jax_t, port_t = jt.PRESETS["strong_album"], pt.build_preset("strong_album")
    for (h, w), n in zip(SIZES, (2, 0, 1, 5)):
        sample = mask_sample(np.random.default_rng([seed, h, w, 1]), h, w, n)
        assert_same_masks(port_t(sample, random.Random(seed)), jax_t(sample, random.Random(seed)))


GEOMETRY = {
    "hflip": lambda m, s, r: m.hflip(s),
    "vflip": lambda m, s, r: m.vflip(s),
    "resize_up": lambda m, s, r: m.resize(s, (2 * s["image"].shape[0] + 3, s["image"].shape[1] + 17)),
    "resize_down": lambda m, s, r: m.resize(s, (max(s["image"].shape[0] // 3, 1), max(s["image"].shape[1] // 2, 1))),
    "crop": lambda m, s, r: m.crop(s, 1, 2, max(s["image"].shape[0] - 5, 1), max(s["image"].shape[1] - 3, 1)),
    "sanitize": lambda m, s, r: m.sanitize(m.crop(s, 0, 0, s["image"].shape[0] // 2 + 1, s["image"].shape[1] // 2 + 1)),
    "iou_crop": lambda m, s, r: m.RandomIoUCrop()(s, r),
    "size_crop": lambda m, s, r: m.RandomSizeCrop(3, 40)(s, r),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_masks_through_geometry(name):
    for seed in SEEDS:
        for h, w in SIZES:
            sample = mask_sample(np.random.default_rng([seed, h, w, 2]), h, w, 4)
            got = GEOMETRY[name](pt, sample, random.Random(seed))
            want = GEOMETRY[name](jt, sample, random.Random(seed))
            assert "masks" in want and len(got["masks"]) == len(got["boxes"])
            assert_same_masks(got, want)


def jax_blend_floats(samples, seed):
    """The float image each JAX copy-paste pair blends before its uint8
    cast, replaying the JAX function's draws (None where nothing is
    pasted)."""
    rng = random.Random(seed)
    out = []
    for sample, paste in zip(samples, samples[-1:] + samples[:-1]):
        if len(paste["masks"]) == 0:
            out.append(None)
            continue
        n = len(paste["masks"])
        sel = sorted(set(rng.randrange(n) for _ in range(n)))
        h, w = sample["image"].shape[:2]
        p_img, p_masks = paste["image"], paste["masks"][sel]
        if p_img.shape[:2] != (h, w):
            p_img = cv2.resize(p_img, (w, h), interpolation=cv2.INTER_LINEAR)
            m = cv2.resize(p_masks.transpose(1, 2, 0).astype(np.uint8), (w, h), interpolation=cv2.INTER_NEAREST)
            p_masks = (m[:, :, None] if m.ndim == 2 else m).transpose(2, 0, 1)
        alpha = cv2.GaussianBlur((p_masks.sum(0) > 0).astype(np.float32), (5, 5), 2.0)
        out.append(sample["image"].astype(np.float32) * (1.0 - alpha[..., None])
                   + p_img.astype(np.float32) * alpha[..., None])
    return out


@pytest.mark.parametrize("sizes", [[(60, 80)] * 4, [(60, 80), (45, 90), (33, 20), (80, 61)]],
                         ids=["equal_sizes", "different_sizes"])
def test_simple_copy_paste_equals_jax(sizes):
    near_integer = mismatched = 0
    for seed in SEEDS:
        rng = np.random.default_rng([seed, 3])
        samples = [mask_sample(rng, h, w, n) for (h, w), n in zip(sizes, (3, 1, 4, 2))]
        got = pt.simple_copy_paste(samples, random.Random(seed))
        want = jt.simple_copy_paste(samples, random.Random(seed))
        floats = jax_blend_floats(samples, seed)
        for g, w_, f in zip(got, want, floats):
            np.testing.assert_array_equal(g["boxes"], w_["boxes"])
            np.testing.assert_array_equal(g["labels"], w_["labels"])
            np.testing.assert_array_equal(g["masks"], w_["masks"])
            assert g["image"].shape == w_["image"].shape and g["image"].dtype == np.uint8
            diff = np.abs(g["image"].astype(np.int32) - w_["image"])
            assert diff.max() <= 1
            if f is None:
                assert diff.max() == 0
                continue
            near = np.abs(f - np.round(f)) < 1e-4
            assert not (diff.astype(bool) & ~near).any()
            near_integer += int(near.sum())
            mismatched += int(diff.astype(bool).sum())
    assert mismatched <= near_integer


@pytest.fixture(scope="module")
def polygon_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("poly")
    sizes = [(96, 128), (128, 96), (70, 101), (101, 70), (96, 128), (80, 120)]
    png = write_coco_split(root / "png", sizes, seed=5, counts=[3, 1, 0, 4, 2, 5], polygons=True)
    npy = write_coco_split(root / "npy", sizes, seed=5, counts=[3, 1, 0, 4, 2, 5], polygons=True, fmt="npy")
    return dict(root=root, png=png, npy=npy)


def test_coco_masks_equal_jax(polygon_split):
    img_dir, ann = polygon_split["png"]
    jax_ds = JaxCocoDetection(str(img_dir), str(ann), train=True, return_masks=True)
    port_ds = CocoDetection(str(img_dir), str(ann), train=True, return_masks=True)
    assert jax_ds.ids == port_ds.ids
    filled = 0
    for i in range(len(port_ds)):
        got, want = port_ds.get_raw(i), jax_ds.get_raw(i)
        assert got["masks"].dtype == bool and got["masks"].shape == want["masks"].shape
        np.testing.assert_array_equal(got["masks"], want["masks"])
        np.testing.assert_array_equal(got["boxes"], want["boxes"])
        filled += int(got["masks"].sum())
    assert filled > 0


def test_train_cli_strong_album_copypaste_without_cv2(polygon_split, tmp_path, monkeypatch):
    img_dir, ann = polygon_split["npy"]
    model = tmp_path / "tiny_model.py"
    model.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                     f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    split = dict(train_dir=img_dir, train_ann=ann, val_dir=img_dir, val_ann=ann, model=model)
    config = write_config(split, tmp_path / "train.py", tmp_path / "out", train_transform="strong_album",
                          copypaste=True)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    summary = train.main(cli(config, "--dry-run-steps", "2"))
    assert summary["global_step"] == 2
    assert all(np.isfinite(v) for v in summary["metrics"].values())
