"""Training entry point of the port, on synthetic batches.

    python -m salience_detr_torch.train --steps N [--seed S] [--model-config F]

Builds the model of ``--model-config`` (a file assigning ``model_config``;
the flagship configs/salience_detr_torch/salience_detr_resnet50_800_1333.py
by default, e.g. salience_detr_resnet50_dcn_800_1333.py beside it for
R50-DCN) with random weights from the seed and trains it for N steps through
:func:`engine.train.train_one_epoch`: B=4 on the 800x1344 canvas, bf16
autocast over float32 master weights, the optimizer settings of
configs/train_config.py (AdamW lr 1e-4, weight decay 1e-4, warmup over the
N steps, clip 0.1), metrics fetched every ``print_freq`` steps.  Prints one
JSON line with the last step's metrics.  Needs a CUDA device.

COCO is not in the repository, so the batches are synthetic, made from the
seed as the JAX bench's train phase makes them: images uniform in [-2, 2],
and per image 24, 7, 40 and 1 gt boxes with random labels, centres uniform in
[0.25, 0.7] and sizes in [0.05, 0.25], padded to ``max_gt`` = 100.
"""

from __future__ import annotations

import argparse
import json
import logging
import runpy
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from salience_detr_torch.engine.optim import build_optimizer, make_lr_schedule
from salience_detr_torch.engine.train import train_one_epoch
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.bricks.criterion import Targets, default_weight_dict
from salience_detr_torch.models.factory import SalienceDETRConfig, build_criteria, build_salience_detr
from salience_detr_torch.parallel.train_step import make_train_step

TRAIN_CONFIG = Path(__file__).resolve().parent.parent / "configs" / "train_config.py"
GT_COUNTS = (24, 7, 40, 1)  # valid gts per image of a synthetic batch of 4


def load_train_config(path=TRAIN_CONFIG) -> Dict:
    """configs/train_config.py's settings (a plain Python file)."""
    return runpy.run_path(str(path))


def synthetic_batch(rng: np.random.Generator, num_classes: int, counts: Sequence[int],
                    canvas, max_gt: int, device) -> Dict:
    """One batch of len(counts) images on the full canvas with padded
    targets; the valid gts of each image come first."""
    B, (H, W) = len(counts), canvas
    images = rng.uniform(-2, 2, size=(B, 3, H, W)).astype(np.float32)
    labels = np.zeros((B, max_gt), np.int64)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    for i, n in enumerate(counts):
        labels[i, :n] = rng.integers(0, num_classes, n)
        boxes[i, :n, :2] = rng.uniform(0.25, 0.7, (n, 2))
        boxes[i, :n, 2:] = rng.uniform(0.05, 0.25, (n, 2))
    valid = np.arange(max_gt)[None] < np.asarray(counts)[:, None]
    targets = Targets(
        torch.from_numpy(labels).to(device), torch.from_numpy(boxes).to(device),
        torch.from_numpy(valid).to(device), tuple(int(n) for n in counts),
    )
    return {
        "images": torch.from_numpy(images).to(device),
        "image_sizes": torch.tensor([[H, W]] * B, device=device),
        "targets": targets,
    }


class Trainer:
    """The model, criteria, optimizer and train step of one config, built
    from a seed; ``generator`` draws the CDN noise on the device."""

    def __init__(self, cfg: SalienceDETRConfig, device, seed: int = 0, steps_per_epoch: int = 1,
                 train_cfg: Optional[Dict] = None):
        tc = train_cfg or load_train_config()
        self.cfg, self.device = cfg, torch.device(device)
        self.max_gt, self.canvas, self.print_freq = tc["max_gt"], tuple(tc["train_canvas"]), tc["print_freq"]
        self.model, _ = build_salience_detr(cfg, self.device, torch.Generator().manual_seed(seed))
        self.criterion, self.salience_criterion = build_criteria(cfg)
        self.optimizer = build_optimizer(
            self.model, tc["learning_rate"], tc["weight_decay"], tuple(tc["betas"])
        )
        schedule = make_lr_schedule(
            tc["learning_rate"], steps_per_epoch, tc["lr_milestones"], tc["lr_gamma"],
            tc["warmup_factor"], min(tc["warmup_steps"], steps_per_epoch),
        )
        amp = self.device.type == "cuda" and cfg.dtype != torch.float32
        self.step = make_train_step(
            self.model, self.criterion, self.salience_criterion, self.optimizer, schedule,
            default_weight_dict(cfg.num_decoder_layers), tc["max_norm"],
            cfg.dtype if amp else None,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def batches(self, steps: int, seed: int, counts: Sequence[int] = GT_COUNTS) -> Iterator[Dict]:
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            yield synthetic_batch(rng, self.cfg.num_classes, counts, self.canvas, self.max_gt,
                                  self.device)


def main(argv=None):
    p = argparse.ArgumentParser("Salience-DETR training on synthetic batches (PyTorch port)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-config", default=str(DEFAULT_CONFIG),
                   help="model config file (the JAX train.py's --config-file)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("salience_detr_torch.train needs a CUDA device")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    trainer = Trainer(load_config(args.model_config), "cuda", args.seed, steps_per_epoch=args.steps)
    t0 = time.perf_counter()
    steps, metrics = train_one_epoch(
        trainer.step, trainer.batches(args.steps, args.seed), trainer.generator, 0,
        trainer.print_freq,
    )
    torch.cuda.synchronize()
    result = {"steps": steps, "seconds": time.perf_counter() - t0,
              "device": torch.cuda.get_device_name(0)}
    result.update({k: float(v) for k, v in metrics.items()})
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
