"""Where the flagship's float16 train step overflows (a diagnostic for the
``--mixed-precision fp16`` path of ``python -m salience_detr_torch.train``).

    python tools/fp16_grad_probe.py [--scales 1 16 65536] [--model-config F] [--padded]

One synthetic train batch (B=4, 800x1344, gts 24/7/40/1, seed 0; with
``--padded`` the images cover 800x1066, 800x1200, 640x853 and 760x1013 of
the canvas, the rest zero pixels as the train loader pads them) through
``forward_and_loss`` under float16 autocast on the CUDA card, then backward
of the loss times each scale, with a hook on every module's outputs: prints
per scale the loss, the parameters whose gradient is not finite, the first
modules (in backward order) whose output gradient is not finite, and the
largest finite output gradients.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from salience_detr_torch.inference import DEFAULT_CONFIG, load_config  # noqa: E402
from salience_detr_torch.models.bricks.criterion import default_weight_dict  # noqa: E402
from salience_detr_torch.models.bricks.denoising import cdn_draws  # noqa: E402
from salience_detr_torch.models.detectors.salience_detr import normalize_images  # noqa: E402
from salience_detr_torch.models.factory import build_criteria, build_salience_detr  # noqa: E402
from salience_detr_torch.parallel.train_step import forward_and_loss  # noqa: E402
from salience_detr_torch.timing import card_line  # noqa: E402
from salience_detr_torch.train import GT_COUNTS, synthetic_batch  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scales", type=float, nargs="+", default=[1.0, 16.0, 65536.0])
    p.add_argument("--model-config", default=str(DEFAULT_CONFIG))
    p.add_argument("--padded", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fp16_grad_probe needs a CUDA device")
    print(card_line())
    dev = torch.device("cuda")
    cfg = dataclasses.replace(load_config(args.model_config), dtype=torch.float16)
    model, _ = build_salience_detr(cfg, dev, torch.Generator().manual_seed(0))
    model.train()
    crit, sal = build_criteria(cfg)
    batch = synthetic_batch(np.random.default_rng(0), cfg.num_classes, GT_COUNTS, (800, 1344), 100, dev)
    if args.padded:
        sizes = [(800, 1066), (800, 1200), (640, 853), (760, 1013)]
        zero = normalize_images(torch.zeros((1, 3, 1, 1), device=dev))  # a zero pixel, normalized
        for i, (h, w) in enumerate(sizes):
            batch["images"][i, :, h:] = zero[0]
            batch["images"][i, :, :, w:] = zero[0]
        batch["image_sizes"] = torch.tensor(sizes, device=dev)
    dn = model.denoising_generator
    draws = cdn_draws(len(GT_COUNTS), dn.num_denoising_queries, dn.num_classes, dn.label_noise_prob,
                      torch.Generator(dev).manual_seed(0), dev)
    nonfinite, largest = [], {}

    def grad_hook(name):
        def hook(g):
            if not bool(torch.isfinite(g).all()):
                nonfinite.append(f"{name} {g.dtype} {tuple(g.shape)}")
            else:
                largest[name] = max(largest.get(name, 0.0), float(g.abs().max()))
        return hook

    def forward_hook(name):
        def hook(module, inputs, output):
            for i, out in enumerate(output if isinstance(output, (tuple, list)) else [output]):
                if isinstance(out, torch.Tensor) and out.requires_grad:
                    out.register_hook(grad_hook(f"{name}[{i}]"))
        return hook

    for name, module in model.named_modules():
        if name:
            module.register_forward_hook(forward_hook(name))
    for scale in args.scales:
        nonfinite.clear()
        largest.clear()
        model.zero_grad(set_to_none=True)
        total, losses, _ = forward_and_loss(model, batch, draws, crit, sal,
                                            default_weight_dict(cfg.num_decoder_layers), torch.float16)
        (total * scale).backward()
        torch.cuda.synchronize()
        bad = [n for n, q in model.named_parameters() if q.grad is not None and not bool(torch.isfinite(q.grad).all())]
        top = sorted(largest.items(), key=lambda kv: -kv[1])[:8]
        print(f"fp16_probe: padded={args.padded} scale={scale:g} loss={float(total):.4f} "
              f"losses_finite={all(bool(torch.isfinite(v)) for v in losses.values())} "
              f"nonfinite_param_grads={len(bad)} {bad[:6]} first_nonfinite_output_grads={nonfinite[:8]} "
              f"largest_finite_output_grads={[(k, f'{v:.4g}') for k, v in top]}")


if __name__ == "__main__":
    main()
