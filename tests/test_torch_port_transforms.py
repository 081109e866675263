"""The port's train augmentations (salience_detr_torch/data/transforms.py)
against the JAX package's (salience_detr_tpu/data/transforms.py), which
resizes with cv2: the same sample and the same ``random.Random(seed)`` give
byte-equal images, boxes equal at atol 1e-5 and equal labels, for every
primitive, the random transforms and every ported preset, over seeds and
odd, portrait, tiny and 240x320 images (resized up to COCO scale by the
presets), with and without boxes.  Every JAX preset is ported; an unknown
one raises by name."""

import random

import numpy as np
import pytest
import torch

from salience_detr_tpu.data import transforms as jt
from salience_detr_torch.data import transforms as pt
from salience_detr_torch.data.coco import CocoDetection
from tests.torch_port_common import two_torch_threads  # noqa: F401

cv2 = pytest.importorskip("cv2")  # the JAX transforms resize with cv2

SIZES = [(61, 47), (130, 70), (3, 5), (240, 320)]
SEEDS = range(4)


def make_sample(rng, h, w, n):
    x0 = rng.uniform(0, w - 1, n)
    y0 = rng.uniform(0, h - 1, n)
    x1 = np.minimum(x0 + rng.uniform(1, w, n), w)
    y1 = np.minimum(y0 + rng.uniform(1, h, n), h)
    boxes = np.stack([x0, y0, x1, y1], -1).astype(np.float32).reshape(-1, 4)
    return {
        "image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "boxes": boxes,
        "labels": rng.integers(1, 91, n).astype(np.int64),
        "area": ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).astype(np.float32),
        "image_id": int(rng.integers(1, 1000)),
        "orig_size": np.asarray([h, w], np.int32),
    }


def assert_same(got, want):
    assert got["image"].dtype == np.uint8 and got["image"].shape == want["image"].shape, (
        got["image"].shape, want["image"].shape)
    np.testing.assert_array_equal(got["image"], want["image"])
    assert got["boxes"].dtype == want["boxes"].dtype and got["boxes"].shape == want["boxes"].shape
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert set(got) == set(want)
    if "area" in want:
        np.testing.assert_array_equal(got["area"], want["area"])


@pytest.mark.parametrize("seed", range(3))
def test_resize_is_byte_equal_to_cv2(seed):
    """Down, up, 2x (OpenCV's area shortcut) and one-pixel sizes, odd widths
    whose rows end past the vector width."""
    rng = np.random.default_rng(seed)
    cases = [(1, 1, 7, 5), (5, 3, 1, 1), (480, 640, 800, 1066), (200, 300, 100, 150)]
    cases += [tuple(int(v) for v in rng.integers(1, 260, 4)) for _ in range(40)]
    for h, w, nh, nw in cases:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        got = pt.resize_linear_u8(torch.from_numpy(img), nh, nw).numpy()
        np.testing.assert_array_equal(got, want.reshape(nh, nw, 3), err_msg=f"{h}x{w} -> {nh}x{nw}")


PRIMITIVES = {
    "hflip": lambda m, s, rng: m.hflip(s),
    "vflip": lambda m, s, rng: m.vflip(s),
    "resize": lambda m, s, rng: m.resize(s, (rng.randint(1, 300), rng.randint(1, 300))),
    "shortest_size": lambda m, s, rng: m.shortest_size(s, rng.choice([480, 800, 33]), rng.choice([None, 1333, 90])),
    "crop": lambda m, s, rng: m.crop(s, rng.randint(0, s["image"].shape[0] - 1),
                                     rng.randint(0, s["image"].shape[1] - 1),
                                     rng.randint(1, s["image"].shape[0]), rng.randint(1, s["image"].shape[1])),
    "crop_empty_then_sanitize": lambda m, s, rng: m.sanitize(m.crop(
        {**s, "boxes": np.clip(s["boxes"], 0, [s["image"].shape[1] / 2] * 4) if len(s["boxes"]) else s["boxes"]},
        0, s["image"].shape[1] - 1, s["image"].shape[0], 1)),
    "sanitize": lambda m, s, rng: m.sanitize(s, rng.choice([1.0, 5.0, 40.0])),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitives(name):
    for seed in SEEDS:
        for h, w in SIZES:
            for n in (0, 5):
                rng = np.random.default_rng([seed, h, w, n])
                sample = make_sample(rng, h, w, n)
                want = PRIMITIVES[name](jt, sample, random.Random(seed))
                got = PRIMITIVES[name](pt, sample, random.Random(seed))
                assert_same(got, want)
                if name == "crop_empty_then_sanitize":
                    assert len(got["boxes"]) == 0  # the crop removed every box


def random_transform_pair(name, dataset):
    """The same random transform in both packages; the mix transforms draw
    from ``dataset``."""
    ctor = {
        "Mosaic": lambda m: m.Mosaic((64, 80)),
        "MixUp": lambda m: m.MixUp(p=0.9),
        "RandomIoUCrop": lambda m: m.RandomIoUCrop(),
        "RandomZoomOut": lambda m: m.RandomZoomOut(p=0.9),
        "RandomPhotometricDistort": lambda m: m.RandomPhotometricDistort(p=0.7),
        "RandomSizeCrop": lambda m: m.RandomSizeCrop(20, 60),
        "RandomCropPad": lambda m: m.RandomCropPad((50, 90)),
        "ScaleJitter": lambda m: m.ScaleJitter((100, 120)),
    }[name]
    pair = ctor(jt), ctor(pt)
    for t in pair:
        if hasattr(t, "set_dataset"):
            t.set_dataset(dataset)
    return pair


@pytest.mark.parametrize("name", ["Mosaic", "MixUp", "RandomIoUCrop", "RandomZoomOut", "RandomPhotometricDistort",
                                  "RandomSizeCrop", "RandomCropPad", "ScaleJitter"])
def test_random_transforms(name):
    rng = np.random.default_rng(3)
    dataset = [make_sample(rng, h, w, n) for (h, w), n in zip(SIZES, (3, 0, 1, 7))]
    jax_t, port_t = random_transform_pair(name, dataset)
    for seed in range(8):
        for (h, w), n in zip(SIZES, (4, 0, 2, 9)):
            sample = make_sample(np.random.default_rng([seed, h, w]), h, w, n)
            assert_same(port_t(sample, random.Random(seed)), jax_t(sample, random.Random(seed)))


def wire(transform, dataset):
    """Set the mix transforms' dataset; returns what was there before."""
    before = []
    if hasattr(transform, "set_dataset"):
        before.append((transform, transform.dataset))
        transform.set_dataset(dataset)
    for child in getattr(transform, "transforms", []):
        before += wire(child, dataset)
    return before


@pytest.mark.parametrize("preset", sorted(pt.PRESETS))
def test_presets(preset):
    rng = np.random.default_rng(4)
    dataset = [make_sample(rng, h, w, n) for (h, w), n in zip(SIZES, (3, 0, 1, 7))]
    jax_t, port_t = jt.PRESETS[preset], pt.build_preset(preset)
    restore = wire(jax_t, dataset)  # the JAX presets are module objects: put them back after
    wire(port_t, dataset)
    try:
        for seed in SEEDS:
            for (h, w), n in zip(SIZES, (0, 3, 1, 12)):
                sample = make_sample(np.random.default_rng([seed, h, w, 7]), h, w, n)
                assert_same(port_t(sample, random.Random(seed)), jax_t(sample, random.Random(seed)))
    finally:
        for t, ds in restore:
            t.dataset = ds


def test_every_jax_preset_is_ported_or_raises_by_name():
    assert set(jt.PRESETS) == set(pt.PRESETS)
    assert not hasattr(pt, "NOT_PORTED")
    with pytest.raises(ValueError, match="unknown train_transform 'nope'"):
        pt.build_preset("nope")
    assert pt.build_preset("detr") is not pt.build_preset("detr")  # fresh objects, no shared state


def test_masks_and_copypaste_raise_by_name(tmp_path):
    """Masks and copy-paste are ported: the dataset takes ``return_masks``
    and a missing annotation file raises by its name."""
    with pytest.raises(FileNotFoundError, match="missing.json"):
        CocoDetection(str(tmp_path), str(tmp_path / "missing.json"), return_masks=True)
    assert callable(pt.simple_copy_paste)
