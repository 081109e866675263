"""What the training-quality tools share (``overfit_check``,
``validate_static_shapes``, ``cli_rehearsal``, ``finetune_rehearsal``,
``quality_campaign``): the device they are asked for, the JAX package's
sampling flags in the port's terms, the train CLI's loop over a
``TrainLoader`` for a number of steps, a quiet COCO evaluation of a split,
the kernels' launch counts, and a model config file for the CLIs.

Imports torch, numpy and the port only."""

from __future__ import annotations

import functools
import logging
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from salience_detr_torch import native

REPO = Path(__file__).resolve().parent.parent.parent
TRAIN_KERNELS = ("msda", "msda_backward", "msda_backward_ordered", "grid_nms", "hungarian")
EVAL_KERNELS = ("msda", "grid_nms", "nms_keep", "msda_q8_quantize", "msda_q8_sample")


def require_device(name: str) -> torch.device:
    """``torch.device(name)``; raises when it is a CUDA device and there is
    none (a tool never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is False (pass --device cpu to run on the CPU)")
    return device


def platform(device: torch.device) -> str:
    """The device's kind: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def sampling_groups(exact: bool, groups: int = 0, decoder_groups: int = -1) -> Tuple[Optional[int], Optional[int]]:
    """The JAX config's ``shared_sampling_locations = not exact``,
    ``sampling_groups`` and ``decoder_sampling_groups`` as the port's
    (encoder, decoder) location groups, None being one group per head."""
    encoder = groups if groups else (None if exact else 1)
    decoder = encoder if decoder_groups < 0 else (decoder_groups or None)
    return encoder, decoder


def sampling_name(exact: bool, groups: int = 0, decoder_groups: int = -1) -> str:
    """The JAX tool's name of the sampling variant."""
    name = f"groups{groups}" if groups else ("exact" if exact else "shared")
    return name + (f"_dec{decoder_groups}" if decoder_groups >= 0 else "")


def launches() -> Dict[str, int]:
    return dict(native.LAUNCHES)


def launches_since(before: Dict[str, int], kernels: Sequence[str], per: int = 1) -> Dict[str, float]:
    """The kernels' launches since ``before``, divided by ``per``."""
    return {k: (native.LAUNCHES[k] - before[k]) / per for k in kernels}


def quiet_logger() -> logging.Logger:
    """A logger for the train and eval loops that shows warnings only (the
    tools print their own lines)."""
    logger = logging.getLogger("salience_detr_torch.quality")
    logger.setLevel(logging.WARNING)
    return logger


def train_steps(step: Callable, loader, device: torch.device, generator: torch.Generator, steps: int,
                log_every: int = 50, label: str = "", after_step: Optional[Callable[[int], None]] = None
                ) -> List[Tuple[int, float]]:
    """``steps`` calls of ``step(batch, generator)`` through the train CLI's
    loop, ``engine.train.train_one_epoch``, over the epochs of a
    ``data.loader.TrainLoader`` (``set_epoch`` 0, 1, ...), its stop request
    ending the last epoch at the step cap; every ``log_every`` steps and at
    the last the loss is fetched, printed and checked finite;
    ``after_step(i)`` runs after step i - 1 with the number of steps done.
    Returns the fetched (step, loss) pairs."""
    from salience_detr_torch.data.loader import DevicePrefetcher, train_to_device
    from salience_detr_torch.engine.train import train_one_epoch

    losses: List[Tuple[int, float]] = []
    done, last = 0, {}
    logger = logging.getLogger("salience_detr_torch.quality.train")
    logger.setLevel(logging.ERROR)  # the step cap's stop request is no warning here

    def counted(batch, gen):
        last["metrics"] = step(batch, gen)
        return last["metrics"]

    def stop_requested() -> bool:
        nonlocal done
        if done % log_every == 0 or done == steps - 1:
            loss = float(last["metrics"]["loss"])
            print(f"{label}step {done:5d}: loss {loss:.4f}", flush=True)
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss {loss} at step {done}")
            losses.append((done, loss))
        done += 1
        if after_step is not None:
            after_step(done)
        return done >= steps

    epoch = 0
    while done < steps:
        loader.set_epoch(epoch)
        batches = iter(DevicePrefetcher(loader, train_to_device, device))
        try:
            train_one_epoch(counted, batches, generator, epoch, print_freq=log_every, global_step=done,
                            logger=logger, stop_requested=stop_requested)
        finally:
            batches.close()
        epoch += 1
    return losses


def evaluate_dataset(eval_step: Callable, dataset, cfg, device: torch.device, batch_size: int,
                     index=None) -> Dict[str, float]:
    """The COCO metrics of ``eval_step`` over ``dataset`` through the
    port's eval loader and evaluator, scored against ``index`` (the
    dataset's own annotations when None)."""
    from salience_detr_torch.data.loader import DetectionLoader, DevicePrefetcher, to_device
    from salience_detr_torch.engine.train import evaluate
    from salience_detr_torch.utils.coco_eval import CocoEvaluator

    loader = DevicePrefetcher(DetectionLoader(dataset, batch_size), functools.partial(to_device, cfg=cfg), device)
    return evaluate(eval_step, loader, CocoEvaluator(index if index is not None else dataset.coco),
                    logger=quiet_logger())


def write_model_config(path: str, **fields) -> str:
    """A model config file for the CLIs: ``model_config =
    SalienceDETRConfig(**fields)``."""
    body = ",\n    ".join(f"{k}={v!r}" for k, v in fields.items())
    with open(path, "w") as f:
        f.write("from salience_detr_torch.models.factory import SalienceDETRConfig\n\n"
                f"model_config = SalienceDETRConfig(\n    {body},\n)\n")
    return path
