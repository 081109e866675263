"""The port's entry points on the CPU: the serving preprocessing against the
JAX package's eval loader, ``Predictor`` in a fresh process that must never
import JAX, and the inference CLI (runs on an explicit ``--device cpu``,
raises when the default ``cuda`` device is missing)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from salience_detr_torch.inference import DEFAULT_CONFIG, letterbox, load_config, preprocess
from salience_detr_torch.models.factory import SalienceDETRConfig
from tests.torch_port_common import TINY_TORCH

ROOT = Path(__file__).resolve().parent.parent

# (config, the JAX CLIs' canvas for it, request sizes: landscape and portrait,
# identity, exact 2x down, up, odd and extreme aspect ratios)
GEOMETRIES = {
    "tiny": (
        lambda: SalienceDETRConfig(**TINY_TORCH), (96, 128),
        [(96, 128), (192, 256), (70, 101), (128, 96), (61, 47), (20, 300), (300, 20)],
    ),
    "flagship": (
        lambda: load_config(DEFAULT_CONFIG), (800, 1344),
        [(480, 640), (1600, 2400), (333, 517), (1024, 768), (90, 1000), (1000, 90)],
    ),
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_preprocess_matches_jax_eval_loader(geometry):
    """Resize, canvas, padding, normalization and sizes of ``preprocess``
    against the JAX package's eval loader (cv2 resize on uint8) and its
    ``normalize_images``: the uint8 pixels byte-equal, the normalized ones
    within float32 rounding."""
    pytest.importorskip("cv2")
    import jax.numpy as jnp

    from salience_detr_tpu.data.loader import DetectionLoader
    from salience_detr_tpu.models.detectors.salience_detr import normalize_images

    make_cfg, canvas_hw, sizes = GEOMETRIES[geometry]
    cfg = make_cfg()
    rng = np.random.default_rng(2)
    requests = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]
    dataset = [
        {"image": img, "boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), np.int64),
         "image_id": i, "orig_size": np.asarray(img.shape[:2], np.int32)}
        for i, img in enumerate(requests)
    ]
    loader = DetectionLoader(
        dataset, batch_size=1, canvas_hw=canvas_hw, max_gt=1, shuffle=False, drop_last=False,
        num_workers=1, eval_min_size=cfg.min_size, eval_max_size=cfg.max_size,
    )
    for img, want in zip(requests, loader):
        got, image_sizes, orig_sizes = letterbox([img], cfg, "cpu")
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want["images"].shape
        np.testing.assert_array_equal(image_sizes.numpy(), want["image_sizes"])
        np.testing.assert_array_equal(orig_sizes.numpy(), want["orig_sizes"])
        np.testing.assert_array_equal(got, want["images"])

        images = preprocess([img], cfg, "cpu")[0].permute(0, 2, 3, 1).numpy()
        ref = np.asarray(normalize_images(jnp.asarray(want["images"], jnp.float32) / 255.0))
        assert np.abs(images - ref).max() <= 1e-6


def run_python(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300, **kw
    )


def test_predictor_serves_without_jax():
    script = f"""
import sys
import numpy as np
from salience_detr_torch.models.factory import SalienceDETRConfig
from salience_detr_torch.inference import Predictor
cfg = SalienceDETRConfig(**{TINY_TORCH!r})
predictor = Predictor(cfg, None, "cpu", seed=0)
rng = np.random.default_rng(0)
sizes = [(60, 80), (120, 90), (96, 96), (40, 128)]
requests = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]
results = predictor(requests)
for (h, w), r in zip(sizes, results):
    assert r["scores"].shape == (20,) and r["labels"].shape == (20,), r
    assert r["boxes"].shape == (20, 4) and bool(r["boxes"].isfinite().all())
    assert r["valid"].shape == (20,) and bool(r["valid"].all())  # the filters are off
    assert float(r["boxes"][:, 2].max()) <= w * 1.5 and float(r["boxes"][:, 3].max()) <= h * 1.5
assert len(predictor.groups(requests)) == 2  # one landscape, one portrait canvas
assert "jax" not in sys.modules and "salience_detr_tpu" not in sys.modules, sorted(sys.modules)
print("ok")
"""
    proc = run_python(["-c", script])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_trainer_trains_without_jax():
    """The train path (CDN, criteria, assignment, optimizer, loop) imports
    no JAX."""
    script = f"""
import sys
import torch
from salience_detr_torch.engine.train import train_one_epoch
from salience_detr_torch.models.factory import SalienceDETRConfig
from salience_detr_torch.train import TRAIN_CONFIG, Trainer
from salience_detr_torch.utils.config import Config
cfg = SalienceDETRConfig(**{TINY_TORCH!r})
tc = Config(str(TRAIN_CONFIG), max_gt=6, train_canvas=(96, 128), print_freq=1).to_dict()
trainer = Trainer(cfg, "cpu", seed=0, steps_per_epoch=2, train_cfg=tc)
batches = trainer.batches(2, seed=0, counts=(3, 1))
steps, metrics = train_one_epoch(trainer.step, batches, trainer.generator, 0, 1)
assert steps == 2 and all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
assert "jax" not in sys.modules and "salience_detr_tpu" not in sys.modules, sorted(sys.modules)
print("ok")
"""
    proc = run_python(["-c", script])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "images"
    d.mkdir()
    for i, (h, w) in enumerate([(70, 90), (110, 80)]):
        np.save(d / f"img{i}.npy", rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))
    cfg = tmp_path / "tiny_config.py"
    cfg.write_text(
        "from salience_detr_torch.models.factory import SalienceDETRConfig\n"
        f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n"
    )
    return d, cfg


def test_cli_runs_on_explicit_cpu(image_dir, tmp_path):
    d, cfg = image_dir
    out = tmp_path / "results.json"
    proc = run_python([
        "-m", "salience_detr_torch.inference", "--image-dir", str(d), "--device", "cpu",
        "--model-config", str(cfg), "--score-threshold", "0", "--save-results", str(out),
    ])
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = json.loads(out.read_text())
    assert [Path(r["image"]).name for r in results] == ["img0.npy", "img1.npy"]
    assert all(len(r["boxes"]) == 20 for r in results)


def test_cli_refuses_to_fall_back_to_cpu(image_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    d, cfg = image_dir
    proc = run_python([
        "-m", "salience_detr_torch.inference", "--image-dir", str(d), "--model-config", str(cfg),
    ])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr


@pytest.mark.parametrize("name", ["salience_detr_resnet50_dcn_800_1333.py", None])
def test_train_cli_model_config_reaches_trainer(name, monkeypatch):
    """``--model-config`` (the JAX train.py's ``--config-file``) is the config
    the entry point's ``Trainer`` builds; without it, the flagship."""
    from salience_detr_torch import train

    built = []

    class Stop(Exception):
        pass

    def trainer(cfg, device, *args, **kwargs):
        built.append((cfg, device))
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(train, "Trainer", trainer)
    argv = ["--steps", "1"] + (["--model-config", str(DEFAULT_CONFIG.parent / name)] if name else [])
    with pytest.raises(Stop):
        train.main(argv)
    cfg, device = built[0]
    assert device == "cuda"
    assert cfg == load_config(DEFAULT_CONFIG.parent / name if name else DEFAULT_CONFIG)
    assert cfg.stage_with_dcn == ((False, True, True, True) if name else (False,) * 4)
