"""Inference entry point of the port: ``Predictor`` and its CLI.

``Predictor(cfg, state_dict, device, seed)`` takes requests as a list of
uint8 HWC RGB arrays and returns, per request, the top-300 boxes (xyxy in the
request's pixels), scores and labels.  On the device it resizes each image so
that its short side is ``cfg.min_size`` and its long side at most
``cfg.max_size`` (the JAX package's eval geometry, truncated sizes, OpenCV's
bilinear uint8 arithmetic), pads it at the top left of a landscape (min x max,
rounded up to 32) or portrait canvas, normalizes, and runs the detector and
post-processing.  The canvas always holds the resized image.  Requests whose
orientations differ are served by one forward per canvas.  Each result
carries the post-process's ``valid`` mask (all true unless the model's
``PostProcess`` has its confidence or NMS filter on); the CLI keeps the
detections that are valid and score above ``--score-threshold``.  A
``Predictor`` sets the process's numerics as the train and eval CLIs do
(``utils.env.configure_numerics``), so that a served image and the same
image in an eval give the same detections.

    python -m salience_detr_torch.inference --image-dir DIR [--device cuda]
        [--state-dict FILE] [--save-results OUT.json] [--show-dir DIR]

``--device`` defaults to ``cuda`` and the CLI raises when that device is
missing.  The images are the folder's ``data.coco.InferenceDataset``: image
files are decoded with cv2 where it is installed; ``.npy`` files holding
uint8 HWC RGB arrays are read with numpy everywhere.  ``--show-dir`` draws
each image's kept detections (``utils.visualize.save_visualization``) into
one file under the image's name (a ``.npy`` input's as ``.png``); drawing
needs cv2, and without it the CLI refuses the flag before it builds the
model.  Without the flag the CLI needs no cv2.
"""

from __future__ import annotations

import argparse
import json
import runpy
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from salience_detr_torch.data.coco import InferenceDataset
from salience_detr_torch.data.transforms import resize_linear_u8
from salience_detr_torch.models.detectors.salience_detr import normalize_images
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.parallel.train_step import make_eval_step
from salience_detr_torch.utils.env import configure_numerics

DEFAULT_CONFIG = (
    Path(__file__).resolve().parent.parent
    / "configs" / "salience_detr_torch" / "salience_detr_resnet50_800_1333.py"
)
CLI_BATCH = 4  # images the CLI hands to one Predictor call


def _round_up(x: int, m: int = 32) -> int:
    return -(-x // m) * m


def canvas_for(h: int, w: int, cfg: SalienceDETRConfig) -> Tuple[int, int]:
    """Landscape (w >= h) or portrait canvas of the eval geometry."""
    short, long = _round_up(cfg.min_size), _round_up(cfg.max_size)
    return (short, long) if w >= h else (long, short)


def resized_size(h: int, w: int, cfg: SalienceDETRConfig) -> Tuple[int, int]:
    r = min(cfg.min_size / min(h, w), cfg.max_size / max(h, w))
    return int(h * r), int(w * r)


def letterbox(images: Sequence, cfg: SalienceDETRConfig, device):
    """Requests of one canvas (uint8 HWC numpy arrays or tensors) -> (canvas
    (B, 3, H, W) uint8, image_sizes (B, 2), orig_sizes (B, 2)) on ``device``:
    each request resized and padded with zeros at the top left."""
    canvas = canvas_for(*images[0].shape[:2], cfg)
    batch = torch.zeros((len(images), 3, *canvas), dtype=torch.uint8, device=device)
    sizes, orig = [], []
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        if canvas_for(h, w, cfg) != canvas:
            raise ValueError(f"request {i} ({h}x{w}) does not belong on canvas {canvas}")
        nh, nw = resized_size(h, w, cfg)
        x = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))
        x = x.to(device)
        batch[i, :, :nh, :nw] = resize_linear_u8(x, nh, nw).permute(2, 0, 1)
        sizes.append((nh, nw))
        orig.append((h, w))
    as_tensor = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return batch, as_tensor(sizes), as_tensor(orig)


def preprocess(images: Sequence[np.ndarray], cfg: SalienceDETRConfig, device):
    """Requests of one canvas -> (images (B, 3, H, W) float32, normalized,
    image_sizes (B, 2), orig_sizes (B, 2)) on ``device``."""
    batch, sizes, orig = letterbox(images, cfg, device)
    return normalize_images(batch.float() / 255.0), sizes, orig


def load_config(path) -> SalienceDETRConfig:
    """A config file assigns ``model_config = SalienceDETRConfig(...)``."""
    return runpy.run_path(str(path))["model_config"]


class Predictor:
    def __init__(
        self,
        cfg: SalienceDETRConfig,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        device="cuda",
        seed: int = 0,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor: device cuda requested but torch.cuda.is_available() is False")
        configure_numerics()
        self.cfg = cfg
        self.model, self.postprocess = build_salience_detr(
            cfg, self.device, torch.Generator().manual_seed(seed)
        )
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.eval_step = make_eval_step(self.model, self.postprocess, cfg.dtype)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor, orig_sizes: torch.Tensor):
        """Detector + post-processing on a preprocessed batch."""
        return self.eval_step({"images": images, "image_sizes": image_sizes, "orig_sizes": orig_sizes})

    def groups(self, requests: Sequence[np.ndarray]) -> List[List[int]]:
        """Request indices grouped by canvas, one forward per group."""
        by_canvas: Dict[Tuple[int, int], List[int]] = {}
        for i, img in enumerate(requests):
            by_canvas.setdefault(canvas_for(*img.shape[:2], self.cfg), []).append(i)
        return list(by_canvas.values())

    def __call__(self, requests: Sequence[np.ndarray]) -> List[Dict[str, torch.Tensor]]:
        results: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(requests)
        for idx in self.groups(requests):
            dets = self.forward(*preprocess([requests[i] for i in idx], self.cfg, self.device))
            for j, i in enumerate(idx):
                results[i] = {k: v[j] for k, v in dets.items()}
        return results


def main(argv=None):
    p = argparse.ArgumentParser("Salience-DETR inference (PyTorch port)")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--model-config", default=str(DEFAULT_CONFIG))
    p.add_argument("--state-dict", default=None, help="upstream-layout .pth state dict")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0, help="init seed when no state dict is given")
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--save-results", default=None)
    p.add_argument("--show-dir", default=None,
                   help="draw each image's detections into this directory, under its name (needs cv2)")
    args = p.parse_args(argv)
    if args.show_dir:
        from salience_detr_torch.utils.visualize import drawing_name, require_cv2, save_visualization

        require_cv2()

    cfg = load_config(args.model_config)
    state = None
    if args.state_dict:
        state = torch.load(args.state_dict, map_location="cpu", weights_only=True)
        state = state.get("model", state)
    predictor = Predictor(cfg, state, args.device, args.seed)
    dataset = InferenceDataset(args.image_dir)
    results = []
    for s in range(0, len(dataset), CLI_BATCH):
        chunk = [dataset[i] for i in range(s, min(s + CLI_BATCH, len(dataset)))]
        for sample, det in zip(chunk, predictor([c["image"] for c in chunk])):
            keep = det["valid"] & (det["scores"] > args.score_threshold)
            pred = {k: det[k][keep].cpu().numpy() for k in ("boxes", "scores", "labels")}
            path = sample["path"]
            if args.show_dir:
                save_visualization(sample["image"], pred, str(Path(args.show_dir) / drawing_name(path)),
                                   score_threshold=args.score_threshold)
            results.append({"image": path, **{k: v.tolist() for k, v in pred.items()}})
            print(f"{path}: {int(keep.sum())} detections", file=sys.stderr)
    if args.save_results:
        with open(args.save_results, "w") as f:
            json.dump(results, f)
    else:
        json.dump(results, sys.stdout)
        print()


if __name__ == "__main__":
    main()
