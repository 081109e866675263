"""The quality tools' synthetic splits (``salience_detr_torch/tools/
synthetic.py``) against the JAX tools' generators: for two seeds each, every
``.npy`` image equals what cv2 decodes from the JAX tool's ``.jpg`` (the
RGB the JAX loader reads), exactly, and the annotation JSON is equal apart
from the ``file_name`` extension; one rich scene at the full 800x1344
canvas; a split is drawn once per directory and seed."""

import json
import os

import numpy as np
import pytest

from salience_detr_torch.tools import synthetic

cv2 = pytest.importorskip("cv2")


def jax_generators():
    from tools.finetune_rehearsal import make_defect_dataset
    from tools.quality_campaign_r5 import make_rich_dataset
    from tools.validate_static_shapes import make_dataset

    return {"rectangles": make_dataset, "rich": make_rich_dataset, "defects": make_defect_dataset}


def port_generators():
    return {"rectangles": synthetic.make_dataset, "rich": synthetic.make_rich_dataset,
            "defects": synthetic.make_defect_dataset}


def assert_same_split(jax_split, port_split):
    (jax_dir, jax_ann), (port_dir, port_ann) = jax_split, port_split
    with open(jax_ann) as f:
        want = json.load(f)
    with open(port_ann) as f:
        got = json.load(f)
    for im in want["images"]:
        assert im["file_name"].endswith(".jpg")
        im["file_name"] = im["file_name"][:-len(".jpg")] + ".npy"
    assert got == want
    for im in got["images"]:
        decoded = cv2.imread(os.path.join(jax_dir, im["file_name"].replace(".npy", ".jpg")), cv2.IMREAD_COLOR)
        image = np.load(os.path.join(port_dir, im["file_name"]))
        assert image.dtype == np.uint8 and image.shape == (im["height"], im["width"], 3)
        np.testing.assert_array_equal(image, decoded[..., ::-1], err_msg=im["file_name"])
    return got


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("name,args", [("rectangles", (6,)), ("rich", (3, (176, 240))), ("defects", (3,))])
def test_split_matches_the_jax_generator(tmp_path, name, args, seed):
    want = jax_generators()[name](str(tmp_path / "jax"), args[0], seed, *args[1:])
    got = assert_same_split(want, port_generators()[name](str(tmp_path / "port"), args[0], seed, *args[1:]))
    assert len(got["images"]) == args[0] and got["annotations"]


def test_rich_scene_at_the_full_canvas(tmp_path):
    want = jax_generators()["rich"](str(tmp_path / "jax"), 1, 5, (800, 1344))
    got = assert_same_split(want, synthetic.make_rich_dataset(str(tmp_path / "port"), 1, 5, (800, 1344)))
    assert (got["images"][0]["height"], got["images"][0]["width"]) == (800, 1344)


def test_a_split_is_drawn_once(tmp_path):
    root = str(tmp_path / "split")
    img_dir, ann = synthetic.make_dataset(root, 4, 3)
    stamp = {f: os.stat(os.path.join(img_dir, f)).st_mtime_ns for f in os.listdir(img_dir)}
    assert synthetic.make_dataset(root, 4, 3) == (img_dir, ann)
    assert {f: os.stat(os.path.join(img_dir, f)).st_mtime_ns for f in os.listdir(img_dir)} == stamp
    synthetic.make_dataset(root, 4, 4)  # another seed draws again
    with open(ann) as f:
        assert len(json.load(f)["images"]) == 4
    assert os.stat(os.path.join(img_dir, "0.npy")).st_mtime_ns != stamp["0.npy"]
