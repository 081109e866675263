"""Grad-CAM for detections (the twin of the JAX tool ``tools/grad_cam.py``):
class-activation maps of the top detections' class scores with respect to
one neck feature level.

    python -m salience_detr_torch.tools.grad_cam --image-dir DIR [--model-config F]
        [--checkpoint F] [--show-dir grad_cam_maps] [--level 1] [--top-k 5] [--limit 10]
        [--device cuda|cpu]

:func:`make_cam_fn` computes the maps (tensors, no cv2): the gradient of the
sum of the top-k max-class sigmoid scores (of the last decoder layer, over
the batch) with respect to the neck's output at ``level``, taken by
``torch.autograd.grad`` on that activation; channel weights are the
gradient's spatial means and CAM = ReLU(sum_c w_c A_c).  A forward hook
hands the transformer that level as a leaf that requires a gradient, so the
backward stops there (the JAX tool differentiates an additive zero probe
on it).  On the card the forward launches the MSDA and grid-NMS kernels and
the backward the MSDA backward kernel, in the design the numerics name
(``ops.deform_attn.backward_design``).  The CLI draws each map with cv2
(resized to the image bilinearly, jet colours, blended half and half beside
the image) under the image's name.  It runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from salience_detr_torch.parallel.train_step import eval_autocast
from salience_detr_torch.tools.common import add_model_args, folder_batches, load_model
from salience_detr_torch.tools.feature_viz import colorize
from salience_detr_torch.utils.visualize import drawing_name, require_cv2


def make_cam_fn(model, level: int, top_k: int, cfg=None) -> Callable[[torch.Tensor, torch.Tensor], Tuple]:
    """(images, image_sizes) -> (cam (B, h, w) float32, the last decoder
    layer's logits (B, Q, K) and boxes (B, Q, 4)), on the model's device;
    ``cfg`` gives the forward's precision (the eval step's; float32
    without it)."""

    dtype = cfg.dtype if cfg is not None else torch.float32

    def cam_fn(images: torch.Tensor, image_sizes: torch.Tensor):
        model.eval()
        probe = {}

        def leaf_level(module, inputs, feats):
            probe["act"] = feats[level].detach().requires_grad_()
            return [probe["act"] if i == level else f for i, f in enumerate(feats)]

        handle = model.neck.register_forward_hook(leaf_level)
        try:
            with torch.enable_grad(), eval_autocast(images.device, dtype):
                out = model(images, image_sizes)
        finally:
            handle.remove()
        logits, coords = out["pred_class"][-1], out["pred_coord"][-1]
        scores = logits.float().sigmoid().max(-1).values  # (B, Q)
        top = torch.topk(scores, top_k, dim=-1).values
        (grad,) = torch.autograd.grad(top.sum(), probe["act"])
        weights = grad.float().mean(dim=(2, 3), keepdim=True)  # GAP of the gradients, (B, C, 1, 1)
        cam = F.relu((weights * probe["act"].detach().float()).sum(1))
        return cam, logits.detach(), coords.detach()

    return cam_fn


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image-dir", required=True)
    add_model_args(p)
    p.add_argument("--show-dir", default="grad_cam_maps")
    p.add_argument("--level", type=int, default=1, help="neck feature level for the CAM")
    p.add_argument("--top-k", type=int, default=5, help="detections whose scores drive the CAM")
    p.add_argument("--limit", type=int, default=10)
    args = p.parse_args(argv)
    cv2 = require_cv2()
    predictor = load_model(args)
    cfg, model = predictor.cfg, predictor.model
    cam_fn = make_cam_fn(model, args.level, args.top_k, cfg)
    os.makedirs(args.show_dir, exist_ok=True)
    count = 0
    for path, batch in folder_batches(args.image_dir, cfg, args.device, args.limit):
        cam, _, _ = cam_fn(batch["images"], batch["image_sizes"])
        base = batch["canvas"][0].permute(1, 2, 0).cpu().numpy()
        h0, w0 = (int(v) for v in batch["image_sizes"][0])
        heat = cv2.resize(colorize(cam[0].cpu().numpy()), (w0, h0), interpolation=cv2.INTER_LINEAR)
        overlay = (0.5 * base[:h0, :w0] + 0.5 * heat).astype(np.uint8)
        panel = np.concatenate([base[:h0, :w0], overlay], axis=1)
        cv2.imwrite(os.path.join(args.show_dir, drawing_name(path)), np.ascontiguousarray(panel[:, :, ::-1]))
        count += 1
    print(f"wrote {count} grad-cam visualizations to {args.show_dir}")


if __name__ == "__main__":
    main()
