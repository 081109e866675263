"""Training-quality validation: train the whole stack on a detectable
synthetic split (coloured rectangles on noise) long enough to learn, then
score real COCO AP with the port's evaluator (the port's twin of the JAX
package's ``tools/validate_static_shapes.py``).

    python -m salience_detr_torch.tools.validate_static_shapes [--steps 600]
        [--batch 4] [--seed 0] [--exact-sampling] [--sampling-groups G]
        [--decoder-sampling-groups G] [--min-ap50 0.30] [--workdir DIR] [--device cuda]

Beyond ``overfit_check`` (loss only) this reaches detection quality through
the CDN curriculum, the grid-NMS two-stage selection and the salience
budgets.  48 images of 128x128 (``tools/synthetic.make_dataset``, written
once per workdir and seed), the ``hflip`` preset on the fixed canvas, a
small model (ResNet-18 trained whole, embed 64, 2+2 layers, 30 queries),
lr 3e-4 after 50 warm-up steps, clip 0.5, float32; the seed drives the
data, the loader's order, the init and the CDN noise.  Prints one JSON line
{"ap", "ap50", "steps", "seed", "sampling", "passed"} (with the kernels'
launches a train step and an eval forward, and seconds) and exits 1 when
AP50 is under ``--min-ap50``.  ``--device`` defaults to cuda and the tool
raises without a card.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from salience_detr_torch.tools.quality import (
    EVAL_KERNELS,
    REPO,
    TRAIN_KERNELS,
    evaluate_dataset,
    launches,
    launches_since,
    platform,
    require_device,
    sampling_groups,
    sampling_name,
    train_steps,
)
from salience_detr_torch.tools.synthetic import CANVAS, NUM_CLASSES, make_dataset

MAX_GT = 8


def model_config(encoder_groups, decoder_groups):
    from salience_detr_torch.models.factory import SalienceDETRConfig

    return SalienceDETRConfig(
        backbone="resnet18", embed_dim=64, num_classes=NUM_CLASSES, num_queries=30,
        num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=96, topk_sa=16,
        layer_filter_ratio=(1.0, 0.5), denoising_nums=8, max_num_embedding=32,
        encoder_sampling_groups=encoder_groups, decoder_sampling_groups=decoder_groups,
        backbone_freeze_indices=(), min_size=CANVAS[0], max_size=CANVAS[1],
        select_box_nums_for_evaluation=20,
    )


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--workdir", default=str(REPO / "build" / "static_shape_validation"))
    p.add_argument("--min-ap50", type=float, default=0.30)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the data, the loader's order, the init and the CDN noise")
    p.add_argument("--exact-sampling", action="store_true",
                   help="one sampling-location group per head instead of the head-shared encoder")
    p.add_argument("--sampling-groups", type=int, default=0,
                   help="G location groups each shared by num_heads / G heads; 0 = follow --exact-sampling")
    p.add_argument("--decoder-sampling-groups", type=int, default=-1,
                   help="decoder override: -1 = follow the encoder, 0 = exact per head, 1..H = G groups")
    p.add_argument("--n-images", type=int, default=48)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = require_device(args.device)

    from salience_detr_torch.data.coco import CocoDetection
    from salience_detr_torch.data.loader import TrainLoader
    from salience_detr_torch.data.transforms import build_preset
    from salience_detr_torch.engine.optim import build_optimizer, make_lr_schedule
    from salience_detr_torch.models.bricks.criterion import default_weight_dict
    from salience_detr_torch.models.factory import build_criteria, build_salience_detr
    from salience_detr_torch.parallel.train_step import make_eval_step, make_train_step
    from salience_detr_torch.utils.env import configure_numerics

    configure_numerics()
    img_dir, ann_file = make_dataset(args.workdir, n_images=args.n_images, seed=args.seed)
    cfg = model_config(*sampling_groups(args.exact_sampling, args.sampling_groups, args.decoder_sampling_groups))
    model, post = build_salience_detr(cfg, device, torch.Generator().manual_seed(args.seed))
    criterion, salience = build_criteria(cfg)

    train_ds = CocoDetection(img_dir, ann_file, transforms=build_preset("hflip"), train=True)
    val_ds = CocoDetection(img_dir, ann_file)
    train_loader = TrainLoader(train_ds, args.batch, canvas_hw=CANVAS, max_gt=MAX_GT, shuffle=True,
                               seed=args.seed, num_workers=2)
    optimizer = build_optimizer(model, 3e-4)
    schedule = make_lr_schedule(3e-4, steps_per_epoch=10**6, warmup_steps=50)
    step = make_train_step(model, criterion, salience, optimizer, schedule,
                           default_weight_dict(cfg.num_decoder_layers), max_norm=0.5)
    generator = torch.Generator(device).manual_seed(7 + 1000 * args.seed)

    t0 = time.perf_counter()
    before = launches()
    losses = train_steps(step, train_loader, device, generator, args.steps)
    train_launches = launches_since(before, TRAIN_KERNELS, args.steps)
    t_train = time.perf_counter() - t0
    before = launches()
    stats = evaluate_dataset(make_eval_step(model, post, cfg.dtype), val_ds, cfg, device, args.batch)
    forwards = -(-len(val_ds) // args.batch)
    result = {
        "ap": round(float(stats["AP"]), 4),
        "ap50": round(float(stats["AP50"]), 4),
        "steps": args.steps,
        "seed": args.seed,
        "sampling": sampling_name(args.exact_sampling, args.sampling_groups, args.decoder_sampling_groups),
        "passed": bool(stats["AP50"] >= args.min_ap50),
        "first_loss": losses[0][1], "last_loss": losses[-1][1],
        "train_s": t_train, "seconds": time.perf_counter() - t0, "platform": platform(device),
        "launches_per_step": train_launches,
        "launches_per_eval_forward": launches_since(before, EVAL_KERNELS, forwards),
    }
    print(json.dumps(result))
    if not result["passed"]:
        raise SystemExit(f"AP50 {result['ap50']} is under --min-ap50 {args.min_ap50}")
    return result


if __name__ == "__main__":
    main()
