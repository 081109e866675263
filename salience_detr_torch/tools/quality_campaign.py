"""Paired quality campaign at the flagship's full transformer geometry on the
800x1344 canvas: exact against hybrid sampling, with AP curves and an
int8-gather evaluation of the same weights (the port's twin of the JAX
package's ``tools/quality_campaign_r5.py``).

    python -m salience_detr_torch.tools.quality_campaign --variant exact|hybrid --seed S
        [--steps 10000] [--eval-every 1000] [--batch 2] [--backbone resnet18|resnet50]
        [--mixed-precision bf16|fp16] [--use-deterministic-algorithms]
        [--out docs/quality_torch_h100.jsonl] [--device cuda]

* the model: embed 256, 8 heads, 4x4 points, 6+6 layers, 900 queries, CDN,
  7 classes, every backbone stage trained (no ImageNet weights exist here);
  ``--backbone resnet18`` (the JAX tool's default) or ``resnet50`` (the
  flagship whole);
* the variants: ``exact`` samples per head everywhere (upstream's numerics),
  ``hybrid`` shares the encoder's locations over the heads and samples the
  decoder per head (the flagship); every evaluation of a hybrid run is done
  twice on the same weights, the second with the int8 encoder sampling
  (``MSDA_GATHER_QUANT=int8``, read at each call; eval only);
* the data: ``tools/synthetic.make_rich_dataset`` at the canvas, 192
  training and 48 validation images (seeds S and S + 9000), written once per
  workdir and seed; the ``hflip`` preset, at most 16 gts an image;
* the schedule: lr 2e-4 after 200 warm-up steps, clip 0.1, bf16 autocast (or
  fp16 with a GradScaler, whose skipped steps are counted); the seed drives
  the data, the loader's order, the init and the CDN noise.

Appends one JSON line to ``--out``: the JAX tool's fields (variant, seed,
steps, canvas, batch, backbone, curve [{step, ap, ap50}], int8_curve,
img_s), the card's name and power limit beside ``img_s``, the precision,
whether deterministic algorithms were on, the kernels' launches a train step
and an eval forward, and under fp16 the scaler's skipped steps.  img_s is
training images over the training seconds (evaluations left out).
``--device`` defaults to cuda and the tool raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

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
    train_steps,
)
from salience_detr_torch.tools.synthetic import RICH_NUM_CLASSES, make_rich_dataset

MAX_GT = 16
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


class SkipCounter:
    """Wraps a train step with a ``GradScaler``: a step whose gradients were
    not finite is skipped by the scaler, which then lowers its scale; that
    is counted here (one host read of the scale a step)."""

    def __init__(self, step, scaler: torch.amp.GradScaler):
        self.step, self.scaler = step, scaler
        self.skipped: List[int] = []
        self.scale = scaler.get_scale()

    def __call__(self, batch, generator):
        metrics = self.step(batch, generator)
        scale = self.scaler.get_scale()
        if scale < self.scale:
            self.skipped.append(self.step.steps_done - 1)
        self.scale = scale
        return metrics


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", choices=["exact", "hybrid"], required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--eval-every", type=int, default=1000)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--canvas", type=int, nargs=2, default=(800, 1344))
    p.add_argument("--backbone", default="resnet18")
    p.add_argument("--n-train", type=int, default=192)
    p.add_argument("--n-val", type=int, default=48)
    p.add_argument("--workdir", default=str(REPO / "build" / "quality_campaign"))
    p.add_argument("--out", default=str(REPO / "docs" / "quality_torch_h100.jsonl"))
    p.add_argument("--no-int8-overlay", action="store_true")
    p.add_argument("--mixed-precision", default="bf16", choices=sorted(DTYPES))
    p.add_argument("--use-deterministic-algorithms", action="store_true")
    p.add_argument("--note", default=None, help="a remark kept in the JSON line (how the run was made)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    overlay = args.variant == "hybrid" and not args.no_int8_overlay
    device = require_device(args.device)

    from salience_detr_torch.data.coco import CocoDetection
    from salience_detr_torch.data.loader import TrainLoader
    from salience_detr_torch.data.transforms import build_preset
    from salience_detr_torch.engine.optim import build_optimizer, make_lr_schedule
    from salience_detr_torch.models.bricks.criterion import default_weight_dict
    from salience_detr_torch.models.factory import SalienceDETRConfig, build_criteria, build_salience_detr
    from salience_detr_torch.parallel.train_step import make_eval_step, make_train_step
    from salience_detr_torch.utils.env import configure_numerics

    configure_numerics(args.use_deterministic_algorithms)
    canvas = tuple(args.canvas)
    seed_root = os.path.join(args.workdir, f"seed{args.seed}")
    train_img, train_ann = make_rich_dataset(os.path.join(seed_root, "train"), args.n_train, args.seed, canvas)
    val_img, val_ann = make_rich_dataset(os.path.join(seed_root, "val"), args.n_val, args.seed + 9000, canvas)

    cuda = device.type == "cuda"
    dtype = DTYPES[args.mixed_precision] if cuda else torch.float32
    # the full flagship transformer: only the backbone's depth and the batch
    # are economised
    cfg = SalienceDETRConfig(
        backbone=args.backbone, num_classes=RICH_NUM_CLASSES, dtype=dtype,
        encoder_sampling_groups=1 if args.variant == "hybrid" else None, decoder_sampling_groups=None,
        backbone_freeze_indices=(), min_size=canvas[0], max_size=canvas[1],
    )
    model, post = build_salience_detr(cfg, device, torch.Generator().manual_seed(args.seed))
    criterion, salience = build_criteria(cfg)
    train_ds = CocoDetection(train_img, train_ann, transforms=build_preset("hflip"), train=True)
    val_ds = CocoDetection(val_img, val_ann)
    train_loader = TrainLoader(train_ds, args.batch, canvas_hw=canvas, max_gt=MAX_GT, shuffle=True,
                               seed=args.seed, num_workers=4)
    optimizer = build_optimizer(model, 2e-4)
    schedule = make_lr_schedule(2e-4, steps_per_epoch=10**6, warmup_steps=200)
    scaler = torch.amp.GradScaler("cuda") if cuda and dtype == torch.float16 else None
    step = make_train_step(model, criterion, salience, optimizer, schedule,
                           default_weight_dict(cfg.num_decoder_layers), max_norm=0.1,
                           autocast_dtype=dtype if cuda else None, scaler=scaler)
    counter = SkipCounter(step, scaler) if scaler is not None else None
    eval_step = make_eval_step(model, post, cfg.dtype)
    quants = ["none"] + (["int8"] if overlay else [])
    forwards = -(-len(val_ds) // args.batch)

    def run_eval(quant: str):
        prev = os.environ.get("MSDA_GATHER_QUANT")
        os.environ["MSDA_GATHER_QUANT"] = quant
        try:
            stats = evaluate_dataset(eval_step, val_ds, cfg, device, args.batch)
        finally:
            if prev is None:
                os.environ.pop("MSDA_GATHER_QUANT", None)
            else:
                os.environ["MSDA_GATHER_QUANT"] = prev
        return round(float(stats["AP"]), 4), round(float(stats["AP50"]), 4)

    curves: Dict[str, List[Dict]] = {q: [] for q in quants}
    eval_launches: Dict[str, Dict] = {}
    eval_total = {k: 0 for k in TRAIN_KERNELS}  # the evaluations' launches, kept out of the steps'
    clock = {"train_s": 0.0, "since": 0.0}

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def after_step(done: int):
        if done % args.eval_every and done < args.steps:
            return
        clock["train_s"] += sync() - clock["since"]
        msg = f"  eval@{done}:"
        for q in quants:
            before = launches()
            ap, ap50 = run_eval(q)
            eval_launches[q] = launches_since(before, EVAL_KERNELS, forwards)
            for k, n in launches_since(before, TRAIN_KERNELS).items():
                eval_total[k] += n
            curves[q].append({"step": done, "ap": ap, "ap50": ap50})
            msg += f" {q} AP {ap:.3f} AP50 {ap50:.3f}"
        print(msg, flush=True)
        clock["since"] = sync()

    generator = torch.Generator(device).manual_seed(7 + 1000 * args.seed)
    before = launches()
    clock["since"] = sync()
    train_steps(counter or step, train_loader, device, generator, args.steps, log_every=100,
                label=f"[{args.variant} s{args.seed}] ", after_step=after_step)
    train_launches = {k: (n - eval_total[k]) / args.steps for k, n in launches_since(before, TRAIN_KERNELS).items()}

    result = {
        "variant": args.variant,
        "seed": args.seed,
        "steps": args.steps,
        "canvas": list(canvas),
        "batch": args.batch,
        "backbone": args.backbone,
        "curve": curves["none"],
        "img_s": round(args.batch * args.steps / max(clock["train_s"], 1e-9), 3),
    }
    if "int8" in curves:
        result["int8_curve"] = curves["int8"]
        result["int8_ap_gap"] = [round(a["ap"] - b["ap"], 4) for a, b in zip(curves["none"], curves["int8"])]
    result.update({
        "card": card_or_cpu(device),
        "mixed_precision": args.mixed_precision if cuda else "no",
        "deterministic": args.use_deterministic_algorithms,
        "train_s": round(clock["train_s"], 3),
        "launches_per_step": train_launches,
        "launches_per_eval_forward": eval_launches,
    })
    if counter is not None:
        result["fp16_skipped_steps"] = len(counter.skipped)
        result["fp16_skipped_at"] = counter.skipped
        result["fp16_final_scale"] = counter.scale
    if args.note:
        result["note"] = args.note
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result))
    return result


def card_or_cpu(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or ``cpu``."""
    if device.type != "cuda":
        return platform(device)
    from salience_detr_torch.timing import card_line

    return card_line()


if __name__ == "__main__":
    main()
