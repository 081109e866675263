"""The train loader's shared preparation (``data/loader.py`` ``TrainLoader``
with ``exchange``) over W gloo ranks on the CPU, each a process of its own
(``salience_detr_torch.tools.ddp_check loader``): rank r prepares the
positions r, r + W, ... of the epoch's order, the ranks exchange the
prepared samples' orientations and instance counts, and each prepares again
only those of its rows and of its rows' copy-paste partners that another
rank prepared.  The ranks' batches, put back together in the rows' order,
equal the one-process batches byte for byte, under the ``detr`` preset and
under ``strong_album`` with copy-paste on polygon masks, at 2 and 4 ranks
and with 2 micro-batches; each rank prepares at most ceil(2N / W) samples
plus one partner a row for copy-paste; and a rank's loader closed after its
first batch (a dry run, a preemption) lets every rank go on to the next
epoch in step."""

import json
import math

import numpy as np
import pytest

from salience_detr_torch.data.coco import CocoDetection
from salience_detr_torch.data.loader import TrainLoader
from salience_detr_torch.data.transforms import build_preset, simple_copy_paste
from salience_detr_torch.parallel.mesh import shard_rows
from salience_detr_torch.tools import ddp_check
from tests.torch_port_common import write_coco_split
from tests.torch_port_common import two_torch_threads  # noqa: F401

SIZES = [(96, 128), (128, 96), (70, 101), (101, 70), (96, 128), (80, 120), (60, 80), (90, 64), (64, 90),
         (96, 100), (72, 96), (100, 80), (88, 120), (120, 88), (64, 64), (96, 72)] * 2
COUNTS = [3, 1, 0, 4, 2, 5, 1, 2, 3, 1, 2, 2, 0, 3, 1, 4] * 2
CANVAS = (96, 128)
BATCH, MAX_GT, SEED, WORKERS = 4, 6, 3, 2


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_coco_split(tmp_path_factory.mktemp("ddp_loader_share"), SIZES, seed=7, fmt="npy", counts=COUNTS,
                            polygons=True)


def one_process(split, preset, copypaste, epoch):
    img_dir, ann = split
    dataset = CocoDetection(str(img_dir), str(ann), transforms=build_preset(preset), train=True,
                            return_masks=copypaste)
    loader = TrainLoader(dataset, BATCH, canvas_hw=CANVAS, max_gt=MAX_GT, seed=SEED, num_workers=WORKERS,
                         batch_transform=simple_copy_paste if copypaste else None)
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("preset,copypaste,world,accumulate", [
    ("detr", False, 2, 1),
    ("detr", False, 4, 1),
    ("strong_album", True, 2, 2),
    ("strong_album", True, 4, 1),
])
def test_shared_preparation_puts_together_the_one_process_batches(split, tmp_path, preset, copypaste, world,
                                                                  accumulate):
    img_dir, ann = split
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "img_dir": str(img_dir), "ann": str(ann), "preset": preset, "copypaste": copypaste, "batch": BATCH,
        "canvas": CANVAS, "max_gt": MAX_GT, "seed": SEED, "num_workers": WORKERS, "accumulate": accumulate,
        "stop_after": 1,
    }))
    ddp_check.launch(["-m", "salience_detr_torch.tools.ddp_check", "loader", "--spec", str(spec), "--out",
                      str(tmp_path), "--device", "cpu"], world, timeout=300)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    rows = [shard_rows(BATCH, r, world, accumulate) for r in range(world)]
    n = len(SIZES)
    for epoch in (0, 1):
        want = one_process(split, preset, copypaste, epoch)
        got_batches = [int(r[f"e{epoch}_batches"]) for r in ranks]
        assert len(want) >= 4 and got_batches == [1 if epoch == 0 else len(want)] * world
        for i in range(got_batches[0]):
            for k, v in want[i].items():
                got = np.empty_like(v)
                for r in range(world):
                    got[rows[r]] = ranks[r][f"e{epoch}_{i}_{k}"]
                np.testing.assert_array_equal(got, v, err_msg=f"epoch {epoch} batch {i} {k}")
        if epoch == 1:  # a whole epoch: about 2/W of the samples a rank, not all of them
            partners = len(set(simple_copy_paste.partners(rows[0], BATCH)) - set(rows[0])) if copypaste else 0
            limit = math.ceil(2 * n / world) + len(want) * partners
            prepared = [int(r["e1_samples"]) for r in ranks]
            assert all(p <= limit for p in prepared), (prepared, limit)
            if not copypaste or world > 2:  # at W = 2 a rank's rows and their partners are the whole batch
                assert all(p < n for p in prepared), prepared
