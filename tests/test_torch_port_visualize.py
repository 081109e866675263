"""The port's drawing against the JAX package's, on the CPU: the boxes drawn
by ``utils.visualize`` byte-equal to ``salience_detr_tpu.utils.visualize``,
``data.coco.InferenceDataset`` equal to the JAX one (and reading ``.npy``),
the inference CLI's ``--show-dir`` files byte-equal to the JAX
``save_visualization`` of the same detections, the refusals by name where
cv2 is missing, and ``tools.visualize_datasets`` against the JAX tool's
files.  Drawing needs cv2 (installed here)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from salience_detr_tpu.data import coco as jax_coco  # noqa: E402
from salience_detr_tpu.utils import visualize as jax_vis  # noqa: E402
from salience_detr_torch import inference  # noqa: E402
from salience_detr_torch.data.coco import InferenceDataset  # noqa: E402
from salience_detr_torch.tools import visualize_datasets  # noqa: E402
from salience_detr_torch.utils import visualize  # noqa: E402
from tests.torch_port_common import TINY_TORCH, two_torch_threads, write_coco_split  # noqa: E402,F401

# (with scores, class names or None), drawn on random boxes: some past the
# image, scores on both sides of the threshold, labels past the names
CASES = {
    "scores_names": (True, ["person", "car", "dog"]),
    "scores_no_names": (True, None),
    "no_scores": (False, ["a", "b"]),
}


def detections(seed, n=12, h=120, w=160, classes=9):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, [w, h], (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes, rng.integers(0, classes, n), rng.uniform(0, 1, n).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_drawn_image_is_byte_equal_to_jax(case):
    with_scores, names = CASES[case]
    image = np.random.default_rng(1).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes, labels, scores = detections(2)
    scores = scores if with_scores else None
    got = visualize.plot_bounding_boxes_on_image(image, boxes, labels, scores, class_names=names)
    want = jax_vis.plot_bounding_boxes_on_image(image, boxes, labels, scores, class_names=names)
    assert got.dtype == np.uint8 and not np.array_equal(got, image)
    np.testing.assert_array_equal(got, want)


def test_save_visualization_writes_the_jax_file(tmp_path):
    image = np.random.default_rng(3).integers(0, 256, (90, 130, 3), dtype=np.uint8)
    boxes, labels, scores = detections(4, h=90, w=130)
    pred = {"boxes": boxes, "labels": labels, "scores": scores}
    visualize.save_visualization(image, pred, str(tmp_path / "port" / "x.png"), score_threshold=0.4)
    jax_vis.save_visualization(image, pred, str(tmp_path / "jax" / "x.png"), score_threshold=0.4)
    assert (tmp_path / "port" / "x.png").read_bytes() == (tmp_path / "jax" / "x.png").read_bytes()


def image_folder(root, seed=5):
    """PNG and JPEG files written with cv2 (mixed-case extensions), a .npy
    array and a file that is not an image."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for name, (h, w) in {"b.png": (70, 90), "a.JPG": (64, 48), "c.png": (110, 80)}.items():
        arrays[name] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        assert cv2.imwrite(str(root / name), arrays[name][:, :, ::-1].copy())
    arrays["d.npy"] = rng.integers(0, 256, (50, 75, 3), dtype=np.uint8)
    np.save(root / "d.npy", arrays["d.npy"])
    (root / "notes.txt").write_text("not an image")
    return arrays


def test_inference_dataset_equals_jax_and_reads_npy(tmp_path):
    arrays = image_folder(tmp_path / "images")
    got, want = InferenceDataset(str(tmp_path / "images")), jax_coco.InferenceDataset(str(tmp_path / "images"))
    npy = str(tmp_path / "images" / "d.npy")
    assert got.paths == sorted(want.paths + [npy])
    for i, path in enumerate(got.paths):
        g = got[i]
        assert g["path"] == path and g["image_id"] == i
        np.testing.assert_array_equal(g["orig_size"], np.asarray(g["image"].shape[:2], np.int32))
        if path == npy:
            np.testing.assert_array_equal(g["image"], arrays["d.npy"])
            continue
        w = want[want.paths.index(path)]
        assert sorted(g) == sorted(w)
        for k in ("image", "boxes", "labels", "orig_size"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(got) == 4


@pytest.fixture
def tiny_config(tmp_path):
    cfg = tmp_path / "tiny_config.py"
    cfg.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                   f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    return cfg


def test_show_dir_files_equal_jax_save_visualization(tmp_path, tiny_config):
    """The CLI's drawings are the JAX ``save_visualization`` of the
    detections it saves, at its score threshold; a ``.npy`` input's drawing
    is written as ``.png``."""
    image_folder(tmp_path / "images")
    shown, results = tmp_path / "shown", tmp_path / "results.json"
    inference.main(["--image-dir", str(tmp_path / "images"), "--model-config", str(tiny_config), "--device", "cpu",
                    "--score-threshold", "0.025", "--show-dir", str(shown), "--save-results", str(results)])
    dataset = InferenceDataset(str(tmp_path / "images"))
    saved = json.loads(results.read_text())
    assert [r["image"] for r in saved] == dataset.paths
    assert sorted(p.name for p in shown.iterdir()) == ["a.JPG", "b.png", "c.png", "d.png"]
    drawn = 0
    for i, r in enumerate(saved):
        pred = {"boxes": np.asarray(r["boxes"], np.float32).reshape(-1, 4),
                "scores": np.asarray(r["scores"], np.float32), "labels": np.asarray(r["labels"], np.int64)}
        drawn += len(pred["boxes"])
        assert len(pred["boxes"]) < 20  # the threshold dropped some of the top 20
        name = Path(r["image"]).name.replace(".npy", ".png")
        jax_vis.save_visualization(dataset[i]["image"], pred, str(tmp_path / "jax" / name), score_threshold=0.025)
        assert (shown / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert drawn > 0


def test_drawing_refuses_without_cv2_by_name(tmp_path, tiny_config, monkeypatch):
    """Without cv2 the drawing functions name it, and the CLI refuses
    ``--show-dir`` before it builds a model; without the flag the CLI runs
    on a folder of ``.npy`` files."""
    (tmp_path / "images").mkdir()
    np.save(tmp_path / "images" / "x.npy", np.zeros((60, 80, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        visualize.plot_bounding_boxes_on_image(np.zeros((8, 8, 3), np.uint8), np.zeros((0, 4)), np.zeros(0))
    with pytest.raises(RuntimeError, match="cv2"):
        visualize.save_visualization(np.zeros((8, 8, 3), np.uint8), {"boxes": np.zeros((0, 4)),
                                                                     "labels": np.zeros(0)}, str(tmp_path / "x.png"))
    args = ["--image-dir", str(tmp_path / "images"), "--model-config", str(tiny_config), "--device", "cpu",
            "--save-results", str(tmp_path / "r.json")]
    real_predictor = inference.Predictor
    monkeypatch.setattr(inference, "Predictor", lambda *a, **k: pytest.fail("model built before the refusal"))
    with pytest.raises(RuntimeError, match="cv2"):
        inference.main(args + ["--show-dir", str(tmp_path / "shown")])
    assert not (tmp_path / "shown").exists()
    monkeypatch.setattr(inference, "Predictor", real_predictor)
    inference.main(args)
    assert len(json.loads((tmp_path / "r.json").read_text())) == 1


def test_visualize_datasets_writes_the_jax_tools_files(tmp_path, monkeypatch):
    import tools.visualize_datasets as jax_tool

    img_dir, ann = write_coco_split(tmp_path / "split", [(60, 80), (90, 70), (64, 64)], seed=3, num_classes=3)
    visualize_datasets.main(["--img-folder", str(img_dir), "--ann-file", str(ann), "--show-dir",
                             str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["visualize_datasets.py", "--img-folder", str(img_dir), "--ann-file", str(ann),
                                      "--show-dir", str(tmp_path / "jax")])
    jax_tool.main()
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["1.jpg", "2.jpg", "3.jpg"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    visualize_datasets.main(["--img-folder", str(img_dir), "--ann-file", str(ann), "--show-dir",
                             str(tmp_path / "hflip"), "--transform", "hflip", "--limit", "2"])
    assert sorted(p.name for p in (tmp_path / "hflip").iterdir()) == ["1.jpg", "2.jpg"]
