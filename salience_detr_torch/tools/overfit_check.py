"""Training-correctness check: overfit one synthetic batch with a small model
and require the loss to fall to under half its first value (the port's twin
of the JAX package's ``tools/overfit_check.py``; the convergence smoke of the
whole stack: CDN, the assignment, the losses, the optimizer).

    python -m salience_detr_torch.tools.overfit_check [--steps 150] [--size 256]
        [--use-deterministic-algorithms] [--device cuda]

The small config (ResNet-18 trained whole, embed 64, 2+2 layers, 4 heads, 60
queries, head-shared sampling), B=2 images uniform in [-1, 1] at size x size
with 6 boxes each drawn from ``np.random.default_rng(0)`` as the JAX tool
draws them, lr 2e-4 after 20 warm-up steps, clip 0.5, float32.  The
rule is tight at 150 steps: the JAX tool reads 0.478 on the CPU, and on the
card the scatter MSDA backward's float atomics move the port's last loss
from run to run (ratio 0.43-0.50); ``--use-deterministic-algorithms``
(the train CLI's flag) pins one trajectory.  Prints the
loss every 10 steps, then one JSON line (first and last loss, their ratio,
the kernels' launches a step, seconds, ``passed``) and exits 1 when the
rule fails.  ``--device`` defaults to cuda and the tool raises without a
card.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from salience_detr_torch.tools.quality import TRAIN_KERNELS, launches, launches_since, platform, require_device


def small_config():
    from salience_detr_torch.models.factory import SalienceDETRConfig

    return SalienceDETRConfig(
        backbone="resnet18", embed_dim=64, num_classes=7, num_queries=60,
        num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=128,
        topk_sa=30, layer_filter_ratio=(1.0, 0.5), denoising_nums=8, max_num_embedding=32,
        encoder_sampling_groups=1, decoder_sampling_groups=1,
        backbone_freeze_indices=(),  # train everything for overfitting
    )


def one_batch(size: int, device) -> Dict:
    """The JAX tool's batch: images, then the boxes' centres and sizes,
    then the labels, from ``default_rng(0)``."""
    from salience_detr_torch.models.bricks.criterion import Targets

    B, M = 2, 6
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    boxes = np.concatenate(
        [rng.uniform(0.25, 0.75, (B, M, 2)), rng.uniform(0.1, 0.25, (B, M, 2))], -1
    ).astype(np.float32)
    labels = rng.integers(0, 7, (B, M))
    return {
        "images": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(device),
        "image_sizes": torch.tensor([[size, size]] * B, device=device),
        "targets": Targets(torch.from_numpy(labels).to(device), torch.from_numpy(boxes).to(device),
                           torch.ones((B, M), dtype=torch.bool, device=device), (M,) * B),
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--size", type=int, default=256, help="square canvas side")
    p.add_argument("--use-deterministic-algorithms", action="store_true",
                   help="bitwise repeatable steps (utils/env.py configure_numerics)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = require_device(args.device)

    from salience_detr_torch.engine.optim import build_optimizer, make_lr_schedule
    from salience_detr_torch.models.bricks.criterion import default_weight_dict
    from salience_detr_torch.models.factory import build_criteria, build_salience_detr
    from salience_detr_torch.parallel.train_step import make_train_step
    from salience_detr_torch.utils.env import configure_numerics

    configure_numerics(args.use_deterministic_algorithms)
    cfg = small_config()
    model, _ = build_salience_detr(cfg, device, torch.Generator().manual_seed(0))
    criterion, salience = build_criteria(cfg)
    optimizer = build_optimizer(model, 2e-4)
    schedule = make_lr_schedule(2e-4, steps_per_epoch=10**6, warmup_steps=20)
    step = make_train_step(model, criterion, salience, optimizer, schedule,
                           default_weight_dict(cfg.num_decoder_layers), max_norm=0.5)
    generator = torch.Generator(device).manual_seed(100)
    batch = one_batch(args.size, device)

    before = launches()
    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        metrics = step(batch, generator)
        if i % 10 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {i:4d}: loss {loss:.4f}", flush=True)
    seconds = time.perf_counter() - t0
    first, last = losses[0], losses[-1]
    print(f"loss {first:.3f} -> {last:.3f} ({last / first:.2%})")
    result = {
        "first_loss": first, "last_loss": last, "ratio": last / first, "steps": args.steps,
        "size": args.size, "platform": platform(device), "seconds": seconds,
        "launches_per_step": launches_since(before, TRAIN_KERNELS, args.steps),
        "passed": bool(last < 0.5 * first),
    }
    print(json.dumps(result))
    if not result["passed"]:
        raise SystemExit("overfit check failed: the loss did not drop by 2x - training is broken")
    print("OVERFIT CHECK PASSED")
    return result


if __name__ == "__main__":
    main()
