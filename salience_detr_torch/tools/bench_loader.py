"""Host throughput of the train input pipeline, apart from the device (the
twin of the JAX tool ``tools/bench_loader.py``).

    python -m salience_detr_torch.tools.bench_loader [--num-images 64] [--batch-size 4] [--canvas 800 1344]
        [--num-workers 8] [--transform detr strong_album+copypaste] [--epochs 3]

Writes a seeded synthetic COCO split into a temporary directory (the JAX
tool's images: sizes drawn in 70-100% of 600x900, a sine ramp plus noise,
12 boxes an image, each with its box as a polygon for copy-paste's masks):
JPEG files where cv2 is installed, so decoding costs what it costs a
user, and ``.npy`` files where it is not; then, for each ``--transform``
(a preset of ``data/transforms.py``; ``+copypaste`` adds
``simple_copy_paste`` as the batch transform over polygon masks), runs the
port's ``TrainLoader`` (``--num-workers`` threads) for a warm-up epoch and
``--epochs`` measured ones, and prints one JSON line:
``{"metric": "loader_img_s", "value": img/s, ...}`` with the images, the
seconds, the workers' host ms a sample and the image format.  The device is
not involved.  What differs from the JAX tool: several transforms in one
run (one line each), the copy-paste variant, the ``.npy`` fallback and the
workers' own ms a sample (``TrainLoader.transform_s``)."""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np


def write_split(root: str, n_images: int, hw=(600, 900), n_boxes: int = 12, seed: int = 0) -> Tuple[str, str, str]:
    """The synthetic split (the JAX tool's draws); returns (image dir,
    annotation file, image format)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    fmt = "jpg" if cv2 is not None else "npy"
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "img")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
        h = int(rng.integers(int(hw[0] * 0.7), hw[0]))
        w = int(rng.integers(int(hw[1] * 0.7), hw[1]))
        xx = np.arange(w)[None, :].repeat(h, 0)
        img = ((np.sin(xx / 17.0)[..., None] * 127 + 128) * 0.5 + rng.integers(0, 255, (h, w, 3)) * 0.5).astype(
            np.uint8)
        name = f"{i}.{fmt}"
        if cv2 is not None:
            cv2.imwrite(os.path.join(img_dir, name), img[..., ::-1])
        else:
            np.save(os.path.join(img_dir, name), img)
        images.append({"id": i, "file_name": name, "height": h, "width": w})
        for _ in range(n_boxes):
            x, y = rng.uniform(5, w * 0.6), rng.uniform(5, h * 0.6)
            bw, bh = rng.uniform(10, w * 0.3), rng.uniform(10, h * 0.3)
            annotations.append({
                "id": len(annotations), "image_id": i, "category_id": int(rng.integers(1, 80)),
                "bbox": [float(x), float(y), float(bw), float(bh)], "area": float(bw * bh), "iscrowd": 0,
                "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]],
            })
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": str(c)} for c in range(1, 81)]}, f)
    return img_dir, ann, fmt


def make_loader(img_dir: str, ann: str, transform: str, batch_size: int, canvas, num_workers: int):
    from salience_detr_torch.data.coco import CocoDetection
    from salience_detr_torch.data.loader import TrainLoader
    from salience_detr_torch.data.transforms import build_preset, simple_copy_paste

    preset, _, extra = transform.partition("+")
    if extra not in ("", "copypaste"):
        raise ValueError(f"--transform {transform!r}: a preset, optionally with +copypaste")
    copypaste = extra == "copypaste"
    dataset = CocoDetection(img_dir, ann, transforms=build_preset(preset), train=True, return_masks=copypaste)
    return TrainLoader(dataset, batch_size, canvas_hw=tuple(canvas), max_gt=100, shuffle=True,
                       num_workers=num_workers, batch_transform=simple_copy_paste if copypaste else None)


def epoch_ids(loader, epoch: int) -> List[int]:
    """The image ids of one epoch's batches, in order."""
    loader.set_epoch(epoch)
    return [int(i) for batch in loader for i in batch["image_ids"]]


def bench(img_dir: str, ann: str, fmt: str, transform: str, batch_size: int, canvas, num_workers: int,
          epochs: int) -> Dict:
    loader = make_loader(img_dir, ann, transform, batch_size, canvas, num_workers)
    warm = len(epoch_ids(loader, 0))  # page cache and buffers
    samples, seconds = loader.samples, loader.transform_s
    t0 = time.perf_counter()
    n = sum(len(epoch_ids(loader, e)) for e in range(1, epochs + 1))
    dt = time.perf_counter() - t0
    return {"metric": "loader_img_s", "value": n / dt, "unit": "img/s", "images": n, "seconds": dt,
            "transform": transform, "num_workers": num_workers, "batch_size": batch_size, "canvas": list(canvas),
            "image_format": fmt, "worker_ms_a_sample": 1e3 * (loader.transform_s - seconds) /
            max(loader.samples - samples, 1), "warmup_images": warm, "host_cores": os.cpu_count()}


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num-images", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--canvas", type=int, nargs=2, default=(800, 1344))
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--transform", nargs="+", default=["detr", "strong_album+copypaste"],
                   help="presets of data/transforms.py, each optionally with +copypaste")
    p.add_argument("--epochs", type=int, default=3, help="measured epochs after a warm-up epoch")
    args = p.parse_args(argv)
    lines = []
    with tempfile.TemporaryDirectory() as root:
        img_dir, ann, fmt = write_split(root, args.num_images)
        for transform in args.transform:
            line = bench(img_dir, ann, fmt, transform, args.batch_size, args.canvas, args.num_workers, args.epochs)
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
