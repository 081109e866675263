"""Salience maps (the twin of the JAX tool ``tools/feature_viz.py``): the
model's hierarchical salience scores, by which the encoder filters its
tokens, drawn over the input images.

    python -m salience_detr_torch.tools.feature_viz --image-dir DIR [--model-config F]
        [--checkpoint F] [--show-dir salience_maps] [--limit 10] [--device cuda|cpu]

:func:`salience_maps` computes them (tensors, no cv2); :func:`colorize` and
the CLI draw them with cv2 (``utils.visualize.require_cv2``): per image a
panel of the resized image and one overlay a level, each level's map
colourised (the jet colour map over its own range), scaled to the image by
nearest neighbour and blended half and half, written under the image's name
(a ``.npy`` input's as ``.png``).  The forward is the eval step's (bf16
autocast on the card for the flagship).  It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from salience_detr_torch.parallel.train_step import eval_autocast
from salience_detr_torch.tools.common import add_model_args, folder_batches, load_model
from salience_detr_torch.utils.visualize import drawing_name, require_cv2


def salience_maps(model, cfg, images: torch.Tensor, image_sizes: torch.Tensor) -> List[torch.Tensor]:
    """The forward's salience scores (``out["salience"]``), level by level
    from the finest: (B, h, w) float32 each."""
    with torch.no_grad(), eval_autocast(images.device, cfg.dtype):
        out = model.eval()(images, image_sizes)
    return [s[..., 0].float() for s in out["salience"]]


def colorize(score: np.ndarray) -> np.ndarray:
    """Score map (h, w) -> jet heat map (h, w, 3) uint8 RGB over its range."""
    cv2 = require_cv2()
    s = score - score.min()
    s = s / max(s.max(), 1e-6)
    return cv2.applyColorMap((s * 255).astype(np.uint8), cv2.COLORMAP_JET)[:, :, ::-1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image-dir", required=True)
    add_model_args(p)
    p.add_argument("--show-dir", default="salience_maps")
    p.add_argument("--limit", type=int, default=10)
    args = p.parse_args(argv)
    cv2 = require_cv2()
    predictor = load_model(args)
    cfg, model = predictor.cfg, predictor.model
    os.makedirs(args.show_dir, exist_ok=True)
    count = 0
    for path, batch in folder_batches(args.image_dir, cfg, args.device, args.limit):
        maps = salience_maps(model, cfg, batch["images"], batch["image_sizes"])
        base = batch["canvas"][0].permute(1, 2, 0).cpu().numpy()
        h0, w0 = (int(v) for v in batch["image_sizes"][0])
        panels = [base[:h0, :w0]]
        for m in maps:
            heat = cv2.resize(colorize(m[0].cpu().numpy()), (w0, h0), interpolation=cv2.INTER_NEAREST)
            panels.append((0.5 * base[:h0, :w0] + 0.5 * heat).astype(np.uint8))
        panel = np.concatenate(panels, axis=1)
        cv2.imwrite(os.path.join(args.show_dir, drawing_name(path)), np.ascontiguousarray(panel[:, :, ::-1]))
        count += 1
    print(f"wrote {count} salience visualizations to {args.show_dir}")


if __name__ == "__main__":
    main()
