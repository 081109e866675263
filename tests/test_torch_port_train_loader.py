"""The port's train data path against the JAX package's: ``CocoDetection``
with a preset (raw samples, augmented samples, the mix transforms' wiring,
``Object365Detection``'s file names), ``TrainLoader`` against the JAX
``DetectionLoader`` over one split written with cv2 (2 epochs, shuffled,
both orientations, ``drop_last`` on and off, ``max_gt`` truncation; every
array equal, the host counts equal to ``gt_valid.sum(1)``), the device
batch of ``train_to_device`` through ``DevicePrefetcher``, ``pack_batch``'s
errors, and ``convert_to_coco_api``."""

import random

import numpy as np
import pytest
import torch

from salience_detr_tpu.data import coco as jcoco
from salience_detr_tpu.data import loader as jloader
from salience_detr_tpu.data import transforms as jt
from salience_detr_tpu.utils import coco_utils as jcoco_utils
from salience_detr_torch.data import coco as pcoco
from salience_detr_torch.data import loader as ploader
from salience_detr_torch.data import transforms as pt
from salience_detr_torch.models.detectors.salience_detr import normalize_images
from salience_detr_torch.utils import coco_utils as pcoco_utils
from tests.torch_port_common import two_torch_threads, write_coco_split  # noqa: F401

pytest.importorskip("cv2")  # the JAX dataset decodes and resizes with cv2

# landscape, portrait, square and odd sizes; some images carry more boxes
# than max_gt, some none, crowd boxes among them
SIZES = [(60, 80), (80, 60), (64, 64), (45, 97), (97, 45), (50, 70), (70, 50), (33, 41), (120, 90), (90, 120),
         (48, 64), (64, 48), (75, 100)]
ARRAYS = ("images", "image_sizes", "orig_sizes", "boxes", "labels", "gt_valid", "image_ids")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_coco_split(tmp_path_factory.mktemp("split"), SIZES, seed=5, crowd_every=7,
                            counts=[3, 0, 9, 1, 6, 2, 0, 5, 8, 4, 7, 1, 3])


def datasets(split, preset):
    img_dir, ann = split
    jax_ds = jcoco.CocoDetection(str(img_dir), str(ann), transforms=jt.PRESETS[preset], train=True)
    port_ds = pcoco.CocoDetection(str(img_dir), str(ann), transforms=pt.build_preset(preset), train=True)
    return jax_ds, port_ds


def test_dataset_samples(split):
    jax_ds, port_ds = datasets(split, "detr")
    assert jax_ds.ids == port_ds.ids and len(port_ds) < len(SIZES)  # images without boxes dropped
    for idx in range(len(port_ds)):
        want, got = jax_ds.get_raw(idx), port_ds.get_raw(idx)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        want, got = jax_ds.get_with_rng(idx, random.Random(idx)), port_ds.get_with_rng(idx, random.Random(idx))
        for k in ("image", "boxes", "labels"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mix_transforms_are_wired_to_the_raw_dataset(split):
    jax_ds, port_ds = datasets(split, "mosaic")
    mosaic = port_ds.transforms.transforms[0]
    assert isinstance(mosaic, pt.Mosaic) and len(mosaic.dataset) == len(port_ds)
    np.testing.assert_array_equal(mosaic.dataset[1]["image"], port_ds.get_raw(1)["image"])
    try:
        for idx in range(3):
            want, got = jax_ds.get_with_rng(idx, random.Random(9)), port_ds.get_with_rng(idx, random.Random(9))
            for k in ("image", "boxes", "labels"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        jt.PRESETS["mosaic"].transforms[0].dataset = None


def test_object365_file_names(split):
    img_dir, ann = split
    info = {"file_name": "patch3\\objects365_v1_00012345.jpg"}
    for train in (True, False):
        got = pcoco.Object365Detection(str(img_dir), str(ann), train=train)._image_file_name(info)
        want = jcoco.Object365Detection(str(img_dir), str(ann), train=train)._image_file_name(info)
        assert got == want


@pytest.mark.parametrize("drop_last,max_gt,preset", [(True, 100, "detr"), (False, 4, "detr"), (False, 3, "hflip")])
def test_train_loader_equals_jax(split, drop_last, max_gt, preset):
    jax_ds, port_ds = datasets(split, preset)
    kw = dict(canvas_hw=(96, 128), max_gt=max_gt, shuffle=True, seed=3, num_workers=3, drop_last=drop_last)
    jax_loader = jloader.DetectionLoader(jax_ds, 3, **kw)
    port_loader = ploader.TrainLoader(port_ds, 3, **kw)
    assert len(port_loader) == len(jax_loader)
    canvases, truncated = set(), False
    for epoch in range(2):
        jax_loader.set_epoch(epoch)
        port_loader.set_epoch(epoch)
        want, got = list(jax_loader), list(port_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in ARRAYS:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            canvases.add(g["images"].shape[1:3])
            device = ploader.train_to_device(g, torch.device("cpu"))
            assert device["targets"].counts == tuple(int(n) for n in g["gt_valid"].sum(1))
            truncated |= max(device["targets"].counts) == max_gt
    assert canvases == {(96, 128), (128, 96)}
    assert truncated or max_gt == 100
    assert port_loader.samples == 2 * len(port_ds) and port_loader.transform_s > 0


def test_batch_transform_rng_equals_jax(split):
    """A batch transform (the copy-paste slot) draws from the same
    (seed, epoch, batch index) stream as the JAX loader's."""
    def reorder(samples, rng):
        rng.shuffle(samples)
        return samples

    jax_ds, port_ds = datasets(split, "hflip")
    kw = dict(canvas_hw=(96, 128), max_gt=8, seed=4, num_workers=2, batch_transform=reorder)
    jax_loader, port_loader = jloader.DetectionLoader(jax_ds, 3, **kw), ploader.TrainLoader(port_ds, 3, **kw)
    for loader in (jax_loader, port_loader):
        loader.set_epoch(1)
    for g, w in zip(port_loader, jax_loader):
        for k in ARRAYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_prefetcher_carries_train_batches(split):
    _, port_ds = datasets(split, "hflip")
    loader = ploader.TrainLoader(port_ds, 2, canvas_hw=(96, 128), max_gt=6, seed=1, num_workers=2)
    host = list(loader)
    prefetcher = ploader.DevicePrefetcher(loader, ploader.train_to_device, "cpu")
    device = list(prefetcher)
    assert len(device) == len(host) and len(prefetcher.waits) == len(host) + 1  # the last wait meets the end
    for d, h in zip(device, host):
        want = normalize_images(torch.from_numpy(h["images"]).permute(0, 3, 1, 2).float() / 255.0)
        torch.testing.assert_close(d["images"], want, rtol=0, atol=0)
        assert d["image_sizes"].dtype == torch.int64
        np.testing.assert_array_equal(d["image_sizes"].numpy(), h["image_sizes"])
        t = d["targets"]
        np.testing.assert_array_equal(t.labels.numpy(), h["labels"])
        np.testing.assert_array_equal(t.boxes.numpy(), h["boxes"])
        np.testing.assert_array_equal(t.valid.numpy(), h["gt_valid"])
        assert t.labels.dtype == torch.int64


def test_pack_batch_errors_and_empty_images():
    img = np.zeros((10, 12, 3), np.uint8)
    empty = {"image": img, "boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), np.int64)}
    got = ploader.pack_batch([empty, empty], (16, 16), 5)
    want = jloader.pack_batch([empty, empty], (16, 16), 5)
    for k in ARRAYS:
        np.testing.assert_array_equal(got[k], want[k])
    assert not got["gt_valid"].any()
    bad = {**empty, "boxes": np.asarray([[1, 1, 1, 5]], np.float32), "labels": np.asarray([1])}
    with pytest.raises(ValueError, match="positive height and width"):
        ploader.pack_batch([bad], (16, 16), 5)
    with pytest.raises(ValueError, match="exceeds canvas"):
        ploader.pack_batch([empty], (8, 8), 5)


def test_convert_to_coco_api(split):
    jax_ds, port_ds = datasets(split, "basic")
    assert pcoco_utils.convert_to_coco_api(port_ds).dataset == jcoco_utils.convert_to_coco_api(jax_ds).dataset
    assert pcoco_utils.get_coco_index_from_dataset(port_ds) is port_ds.coco

    class Plain:  # a dataset without an index
        def __init__(self, ds):
            self.samples = [ds.get_raw(i) for i in range(3)]

        def __len__(self):
            return len(self.samples)

        def __getitem__(self, i):
            return self.samples[i]

    assert (pcoco_utils.get_coco_index_from_dataset(Plain(port_ds)).dataset
            == jcoco_utils.get_coco_index_from_dataset(Plain(jax_ds)).dataset)
