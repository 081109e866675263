"""The rank-sharded loaders of a data-parallel run (``data/loader.py``): each
rank's ``TrainLoader`` batches, put back together in the rows' order
(``parallel.mesh.shard_rows``), equal the one-process batches byte for byte,
under the ``detr`` preset and under ``strong_album`` with copy-paste (which
rolls the global batch by one, so a rank's first image pastes from the
previous rank's last), at 2 and 4 ranks and with 2 micro-batches; the
eval ``DetectionLoader`` of rank r yields batches r, r + W, ... of the
one-process sequence, planned from the annotations' sizes, and raises when a
decoded image's orientation contradicts them."""

import json

import numpy as np
import pytest

from salience_detr_torch.data.coco import CocoDetection
from salience_detr_torch.data.loader import DetectionLoader, TrainLoader
from salience_detr_torch.data.transforms import build_preset, simple_copy_paste
from salience_detr_torch.parallel.mesh import shard_rows
from tests.torch_port_common import write_coco_split
from tests.torch_port_common import two_torch_threads  # noqa: F401

SIZES = [(96, 128), (128, 96), (70, 101), (101, 70), (96, 128), (80, 120), (60, 80), (90, 64), (64, 90),
         (96, 100)]
COUNTS = [3, 1, 0, 4, 2, 5, 1, 2, 3, 1]
CANVAS = (96, 128)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_coco_split(tmp_path_factory.mktemp("ddp_loader"), SIZES, seed=4, fmt="npy", counts=COUNTS,
                            polygons=True)


def loader(split, preset, copypaste, batch, **kw):
    img_dir, ann = split
    dataset = CocoDetection(str(img_dir), str(ann), transforms=build_preset(preset), train=True,
                            return_masks=copypaste)
    return TrainLoader(dataset, batch, canvas_hw=CANVAS, max_gt=6, shuffle=True, seed=3, num_workers=2,
                       drop_last=False, batch_transform=simple_copy_paste if copypaste else None, **kw)


@pytest.mark.parametrize("preset,copypaste,batch,world,accumulate", [
    ("detr", False, 4, 2, 1),
    ("detr", False, 4, 4, 1),
    ("detr", False, 4, 2, 2),
    ("strong_album", True, 4, 2, 1),
    ("strong_album", True, 4, 2, 2),
])
def test_rank_batches_put_together_equal_the_one_process_batches(split, preset, copypaste, batch, world,
                                                                 accumulate):
    one = list(loader(split, preset, copypaste, batch))
    ranks = [list(loader(split, preset, copypaste, batch, rank=r, world=world, accumulate_steps=accumulate))
             for r in range(world)]
    assert len(one) >= 2 and all(len(r) == len(one) for r in ranks)
    rows = [shard_rows(batch, r, world, accumulate) for r in range(world)]
    for i, want in enumerate(one):
        for k, v in want.items():
            got = np.empty_like(v)
            for r in range(world):
                assert ranks[r][i][k].shape[0] == batch // world
                got[rows[r]] = ranks[r][i][k]
            np.testing.assert_array_equal(got, v, err_msg=f"batch {i} {k}")
    if copypaste:  # copy-paste changed the images it composited
        plain = list(loader(split, preset, False, batch))
        assert any(not np.array_equal(a["images"], b["images"]) for a, b in zip(one, plain))


def test_copy_paste_rows_are_the_whole_batch_rows(split):
    img_dir, ann = split
    dataset = CocoDetection(str(img_dir), str(ann), train=True, return_masks=True)
    samples = [dataset.get_raw(i) for i in range(4)]
    import random

    whole = simple_copy_paste([dict(s) for s in samples], random.Random(5))
    for rows in ([0, 1], [2, 3], [1, 3]):
        part = simple_copy_paste([dict(s) for s in samples], random.Random(5), rows=rows)
        assert len(part) == len(rows)
        for r, got in zip(rows, part):
            for k in ("image", "boxes", "labels", "masks"):
                np.testing.assert_array_equal(got[k], whole[r][k])


def eval_batches(dataset, batch, **kw):
    return [(list(b["image_ids"]), b["images"]) for b in DetectionLoader(dataset, batch, num_workers=2, **kw)]


@pytest.mark.parametrize("world", [2, 3])
def test_eval_ranks_take_every_world_th_batch(split, world):
    img_dir, ann = split
    dataset = CocoDetection(str(img_dir), str(ann))
    one = eval_batches(dataset, 2)
    assert len(one) >= 4
    for r in range(world):
        mine = eval_batches(dataset, 2, rank=r, world=world)
        want = one[r::world]
        assert [ids for ids, _ in mine] == [ids for ids, _ in want]
        for (_, got), (_, images) in zip(mine, want):
            assert all(np.array_equal(a, b) for a, b in zip(got, images))
    plan = DetectionLoader(dataset, 2).plan()
    assert [[int(dataset.ids[i]) for i in b] for b in plan] == [ids for ids, _ in one]


def test_eval_orientation_against_the_annotations_raises(split, tmp_path):
    img_dir, ann = split
    data = json.loads(ann.read_text())
    data["images"][1]["height"], data["images"][1]["width"] = 96, 128  # a portrait image said landscape
    wrong = tmp_path / "ann.json"
    wrong.write_text(json.dumps(data))
    dataset = CocoDetection(str(img_dir), str(wrong))
    with pytest.raises(ValueError, match=r"eval images \[2\]: the decoded orientation differs"):
        for r in range(2):
            eval_batches(dataset, 2, rank=r, world=2)
