"""Training and evaluation loops (port of salience_detr_tpu/engine/train.py).

The train step's metrics stay on the device and are fetched only every
``print_freq`` steps (one synchronisation per interval), logged through
``MetricLogger`` and the tracker; a non-finite loss at a fetch raises.  In a
data-parallel run the fetched metrics are averaged over the ranks first (one
all-reduce per interval), so every rank logs, checks and raises alike.  A
stop request (``utils.env.GracefulShutdown``, or the train step's
``should_stop``, which the ranks agree on) is polled once per step and ends
the epoch after that step.  The eval loop fetches each batch's detections in
one host transfer and hands the valid ones to the COCO evaluator; with an
``all_gather_fn`` it merges the ranks' predictions before scoring."""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from salience_detr_torch.parallel.mesh import mean_over_ranks
from salience_detr_torch.utils.logging_utils import MetricLogger, setup_logger

LOGGER = logging.getLogger("salience_detr_torch.train")


def train_one_epoch(train_step: Callable, loader: Iterable, generator: Optional[torch.Generator],
                    epoch: int, print_freq: int = 50, global_step: int = 0, logger=None,
                    tracker: Optional[Callable[[Dict[str, float], int], None]] = None,
                    stop_requested: Optional[Callable[[], bool]] = None,
                    ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Runs ``train_step(batch, generator)`` over ``loader``; returns the
    global step after the epoch and the last step's metrics, on the device."""
    logger = logger or LOGGER
    metric_logger = MetricLogger(logger=logger)
    metrics: Dict[str, torch.Tensor] = {}
    steps = 0
    for i, batch in enumerate(metric_logger.log_every(loader, print_freq, f"Epoch: [{epoch}]")):
        metrics = train_step(batch, generator)
        steps += 1
        if stop_requested is not None and stop_requested():
            logger.warning(f"stop requested at epoch {epoch} step {i}: ending epoch early")
            break
        if i % print_freq == 0:
            host = {k: float(v) for k, v in mean_over_ranks(metrics).items()}
            if not math.isfinite(host["loss"]):
                logger.error(f"Loss is {host['loss']}, stopping training\n{host}")
                raise FloatingPointError(f"non-finite loss: {host}")
            metric_logger.update(**host)
            if tracker is not None:
                tracker({f"loss/{k}": v for k, v in host.items()}, global_step + i)
    return global_step + steps, metrics


def detections_to_host(dets: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Post-process outputs (B, k) -> numpy, in one device-to-host copy of a
    packed (B, k, 7) float32 tensor (labels and the valid mask are exact in
    float32)."""
    packed = torch.cat([
        dets["boxes"].float(), dets["scores"].float()[..., None],
        dets["labels"].float()[..., None], dets["valid"].float()[..., None],
    ], -1).cpu().numpy()
    return {"boxes": packed[..., :4], "scores": packed[..., 4],
            "labels": packed[..., 5].astype(np.int64), "valid": packed[..., 6] > 0}


def evaluate(eval_step: Callable, loader: Iterable, evaluator, logger=None,
             print_freq: int = 50, tracker: Optional[Callable[[Dict[str, float], int], None]] = None,
             epoch: int = 0, all_gather_fn: Optional[Callable] = None) -> Dict[str, float]:
    """COCO evaluation loop: ``eval_step(batch)`` per device batch (which
    carries its ``image_ids``), the valid detections to ``evaluator``, the
    ranks' predictions merged through ``all_gather_fn`` (``Mesh.
    all_gather_object`` in a data-parallel run: each rank evaluated a shard
    of the images), then accumulate and summarize; returns the 12-metric
    dict, the same on every rank."""
    logger = logger or setup_logger()
    metric_logger = MetricLogger(logger=logger)
    for batch in metric_logger.log_every(loader, print_freq, "Test:"):
        dets = detections_to_host(eval_step(batch))
        preds = {}
        for i, img_id in enumerate(batch["image_ids"]):
            valid = dets["valid"][i]
            preds[int(img_id)] = {k: dets[k][i][valid] for k in ("boxes", "scores", "labels")}
        evaluator.update(preds)

    evaluator.synchronize_between_processes(all_gather_fn)
    evaluator.accumulate()
    stats = evaluator.summarize()
    logger.info(" ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    logger.info("\n" + evaluator.per_category_table())
    if tracker is not None:
        tracker({f"val/{k}": v for k, v in stats.items()}, epoch)
    return stats
