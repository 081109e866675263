"""Write the port's notebooks (the twins of the JAX package's
``inference.ipynb`` and ``grad_cam/{grad_cam,feat_show}.ipynb``, which
``tools/make_notebooks.py`` writes): single-image inference, Grad-CAM and the
feature and salience maps, through the port's API alone, on the card when
there is one.

    python -m salience_detr_torch.tools.make_notebooks

writes ``notebooks_torch/{inference,grad_cam,feat_show}.ipynb`` under the
repository root (edit this file, not the JSON)."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "notebooks_torch"


def nb(cells):
    return {
        "cells": [
            {
                "cell_type": kind,
                "metadata": {},
                "source": src.splitlines(keepends=True),
                **({"outputs": [], "execution_count": None} if kind == "code" else {}),
            }
            for kind, src in cells
        ],
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python", "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


PREAMBLE = """\
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from matplotlib import pyplot as plt

# run from the repository root
if not os.path.exists("salience_detr_torch"):
    os.chdir(os.path.dirname(os.path.abspath(".")))
sys.path.insert(0, os.path.abspath("."))

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"  # the kernels run on the card
"""

LOAD_MODEL = """\
from salience_detr_torch.inference import DEFAULT_CONFIG, Predictor, load_config
from salience_detr_torch.test import load_state_dict

cfg = load_config(DEFAULT_CONFIG)  # the flagship R50 config (bf16 on the card)

# Trained weights: a state dict of this config (the train CLI's
# <output_dir>/checkpoints/<epoch>.pth holds one under "model").  An
# upstream release's .pth is evaluated in its exact sampling mode by
#   python -m salience_detr_torch.test --torch-checkpoint F ...
CHECKPOINT = "checkpoints/salience_detr_resnet50.pth"  # <- point at your run
found = os.path.exists(CHECKPOINT)
predictor = Predictor(cfg, load_state_dict(CHECKPOINT) if found else None, DEVICE)
model, postprocess = predictor.model, predictor.postprocess  # model in eval mode
class_names = None  # e.g. the train CLI's <output_dir>/label_names.txt, one name a line
if not found:
    print("no checkpoint found - continuing with random init (boxes will be noise)")
"""

PREP_IMAGE = """\
from salience_detr_torch.data.coco import load_image
from salience_detr_torch.inference import letterbox
from salience_detr_torch.models.detectors.salience_detr import normalize_images

IMAGE_PATH = "build/notebook_demo.npy"  # <- any image file (cv2 decodes it) or uint8 HWC RGB .npy
if not os.path.exists(IMAGE_PATH):
    # a synthetic scene, so that the notebook runs out of the box
    os.makedirs(os.path.dirname(IMAGE_PATH), exist_ok=True)
    demo = np.full((480, 640, 3), 80, np.uint8)
    demo[120:330, 100:260] = (220, 60, 50)
    yy, xx = np.mgrid[:480, :640]
    demo[(yy - 200) ** 2 + (xx - 450) ** 2 < 70 ** 2] = (60, 200, 70)
    np.save(IMAGE_PATH, demo)

image = load_image(IMAGE_PATH)
# the eval geometry: short side to cfg.min_size (long side at most
# cfg.max_size), zero-padded at the top left of an 800x1344 canvas
canvas, image_sizes, orig_sizes = letterbox([image], cfg, DEVICE)
images = normalize_images(canvas.float() / 255.0)
rh, rw = (int(v) for v in image_sizes[0])
resized = canvas[0, :, :rh, :rw].permute(1, 2, 0).cpu().numpy()
plt.imshow(image); plt.axis("off");
"""

INFER = """\
from salience_detr_torch.parallel.train_step import make_eval_step

eval_step = make_eval_step(model, postprocess, cfg.dtype)  # forward + top-300 post-process
dets = eval_step({"images": images, "image_sizes": image_sizes, "orig_sizes": orig_sizes})
keep = dets["valid"][0] & (dets["scores"][0] > 0.5)
boxes, scores, labels = (dets[k][0][keep].cpu().numpy() for k in ("boxes", "scores", "labels"))
print(f"{int(keep.sum())} detections above 0.5")
"""

VIZ = """\
# drawing needs cv2 (the card's machine may have none; save `dets` and draw elsewhere)
from salience_detr_torch.utils.visualize import plot_bounding_boxes_on_image

shown = plot_bounding_boxes_on_image(
    image, boxes, labels, scores, class_names=class_names, score_threshold=0.5,
)
plt.figure(figsize=(10, 7)); plt.imshow(shown); plt.axis("off");
"""

inference_nb = nb([
    ("markdown",
     "# Salience-DETR (PyTorch port) - single-image inference\n\n"
     "Build the model from a config file, load trained weights, run one image "
     "and draw its detections.  For a folder of images use the CLI, "
     "`python -m salience_detr_torch.inference --image-dir DIR [--show-dir OUT]`.\n\n"
     "## 1. Import packages"),
    ("code", PREAMBLE),
    ("markdown", "## 2. Load a model"),
    ("code", LOAD_MODEL),
    ("markdown", "## 3. Prepare the image\n\nThe eval geometry: a shortest-side "
     "resize onto the static 800x1344 canvas."),
    ("code", PREP_IMAGE),
    ("markdown", "## 4. Inference"),
    ("code", INFER),
    ("markdown", "## 5. Draw the detections"),
    ("code", VIZ),
])

GRADCAM_BODY = """\
from salience_detr_torch.tools.grad_cam import make_cam_fn

feature_level = 1   # neck level the CAM differentiates against (0..3)
top_k = 5           # detections whose class scores drive the CAM

cam_fn = make_cam_fn(model, feature_level, top_k, cfg)
cam, logits, coords = cam_fn(images, image_sizes)  # on the card: the MSDA backward kernel
"""

GRADCAM_VIZ = """\
from salience_detr_torch.tools.feature_viz import colorize  # cv2's jet colour map

# the CAM scaled to the resized image, coloured and blended
cam_hw = F.interpolate(cam[:, None], size=(rh, rw), mode="bilinear", align_corners=False)[0, 0]
heat = colorize(cam_hw.cpu().numpy())
overlay = (0.5 * heat + 0.5 * resized).astype(np.uint8)

plt.figure(figsize=(10, 7)); plt.imshow(overlay); plt.axis("off")
plt.title(f"Grad-CAM, neck level {feature_level}");
"""

grad_cam_nb = nb([
    ("markdown",
     "# Grad-CAM for detections\n\nClass-activation maps of the top detections' "
     "class scores with respect to one neck feature level "
     "(`salience_detr_torch/tools/grad_cam.py`): the gradient is taken by "
     "`torch.autograd.grad` on that activation, which a forward hook hands the "
     "transformer as a leaf.\n\n### Preliminary: model and image (as in inference.ipynb)"),
    ("code", PREAMBLE),
    ("code", LOAD_MODEL),
    ("code", PREP_IMAGE),
    ("markdown", "### Grad-CAM\n\nChannel weights = the spatially pooled "
     "gradients of the summed top-k class scores; CAM = ReLU(sum_c w_c A_c)."),
    ("code", GRADCAM_BODY),
    ("code", GRADCAM_VIZ),
])

FEAT_BODY = """\
# the multi-level backbone and neck feature maps, caught by forward hooks
captured = {}
hooks = [
    model.backbone.register_forward_hook(lambda m, i, out: captured.__setitem__("backbone", list(out.values()))),
    model.neck.register_forward_hook(lambda m, i, out: captured.__setitem__("neck", list(out))),
]
from salience_detr_torch.tools.feature_viz import salience_maps

try:
    maps = salience_maps(model, cfg, images, image_sizes)  # one eval forward
finally:
    for h in hooks:
        h.remove()
backbone_feats = [f.float().cpu() for f in captured["backbone"]]
neck_feats = [f.float().cpu() for f in captured["neck"]]
print("backbone:", [tuple(f.shape) for f in backbone_feats])
print("neck:    ", [tuple(f.shape) for f in neck_feats])
"""

FEAT_VIZ = """\
# channel mean per level
plt.figure(figsize=(16, 4))
for i, f in enumerate(neck_feats):
    plt.subplot(1, len(neck_feats), i + 1)
    plt.imshow(f[0].abs().mean(0), cmap="jet")
    plt.title(f"neck level {i}  {f.shape[2]}x{f.shape[3]}")
    plt.axis("off")
"""

FEAT_SALIENCE = """\
# Salience-DETR's learned foreground confidence, by which the encoder filters
# its tokens (the same forward's out["salience"]); for heat-map files of a
# folder: python -m salience_detr_torch.tools.feature_viz --image-dir DIR
plt.figure(figsize=(16, 4))
for i, m in enumerate(maps):
    plt.subplot(1, len(maps), i + 1)
    plt.imshow(m[0].cpu(), cmap="jet")
    plt.title(f"salience level {i}  {m.shape[1]}x{m.shape[2]}")
    plt.axis("off")
"""

feat_show_nb = nb([
    ("markdown",
     "# Feature and salience maps\n\nThe multi-scale feature maps the detector "
     "computes for an image, and its salience maps.\n\n### Preliminary"),
    ("code", PREAMBLE),
    ("code", LOAD_MODEL),
    ("code", PREP_IMAGE),
    ("markdown", "### Extract feature maps"),
    ("code", FEAT_BODY),
    ("markdown", "### Plot per-level channel means"),
    ("code", FEAT_VIZ),
    ("markdown", "### Salience maps"),
    ("code", FEAT_SALIENCE),
])

NOTEBOOKS = {"inference.ipynb": inference_nb, "grad_cam.ipynb": grad_cam_nb, "feat_show.ipynb": feat_show_nb}


def main():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, notebook in NOTEBOOKS.items():
        path = OUT_DIR / name
        path.write_text(json.dumps(notebook, indent=1) + "\n")
        print("wrote", path.relative_to(ROOT))


if __name__ == "__main__":
    main()
