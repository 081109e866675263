"""Training loop (port of salience_detr_tpu/engine/train.py::train_one_epoch).

The step's metrics stay on the device and are fetched only every
``print_freq`` steps (one synchronisation per interval); a non-finite loss
at a fetch raises."""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Iterable, Tuple

import torch

LOGGER = logging.getLogger("salience_detr_torch.train")


def train_one_epoch(train_step: Callable, loader: Iterable, generator: torch.Generator,
                    epoch: int, print_freq: int = 50,
                    global_step: int = 0) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Runs ``train_step(batch, generator)`` over ``loader``; returns the
    global step after the epoch and the last step's metrics, on the device."""
    metrics: Dict[str, torch.Tensor] = {}
    steps = 0
    for i, batch in enumerate(loader):
        metrics = train_step(batch, generator)
        steps += 1
        if i % print_freq == 0:
            host = {k: float(v) for k, v in metrics.items()}
            if not math.isfinite(host["loss"]):
                LOGGER.error("Loss is %s, stopping training: %s", host["loss"], host)
                raise FloatingPointError(f"non-finite loss: {host}")
            LOGGER.info("Epoch: [%d] [%d] loss %.4f grad_norm %.4f", epoch, i, host["loss"],
                        host["grad_norm"])
    return global_step + steps, metrics
