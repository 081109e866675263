"""Evaluation entry point of the port (root ``test.py``'s counterpart):
evaluate a model on a COCO-format split, or re-score a saved predictions
JSON, and print the 12 COCO box metrics (``AP=... AP50=...``) and the
per-category table.

    python -m salience_detr_torch.test --coco-img DIR --coco-ann FILE
        [--model-config FILE] [--torch-checkpoint FILE | --checkpoint FILE]
        [--batch-size N] [--seed S] [--save-results OUT.json] [--device cuda] [--dist-backend nccl|gloo]
    torchrun --nproc_per_node N -m salience_detr_torch.test --coco-img DIR --coco-ann FILE ...
    python -m salience_detr_torch.test --coco-img DIR --coco-ann FILE --result-file PRED.json

``--torch-checkpoint`` takes an upstream-layout state dict (a released
``.pth``) and evaluates it in the checkpoint-exact per-head sampling mode
(:func:`models.factory.exact_sampling`), loaded ``strict=True``;
``--checkpoint`` takes a state dict of the port's own config as it is.
Without either, the weights are random from ``--seed``.  ``--device``
defaults to ``cuda`` and the CLI raises when that device is missing.  Images
are decoded with cv2 where it is installed; ``.npy`` files holding uint8 HWC
RGB arrays are read with numpy everywhere (``data/coco.py``).

Under the launcher (``parallel/mesh.py``) each rank evaluates its shard of
the one-process batches on ``cuda:LOCAL_RANK`` (or the CPU), the ranks'
predictions are merged over a gloo group before scoring, every rank holds
the same stats, and rank 0 alone logs and writes ``--save-results``.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Dict, Optional

import numpy as np
import torch

from salience_detr_torch import native
from salience_detr_torch.data.coco import CocoDetection, CocoIndex
from salience_detr_torch.data.loader import DetectionLoader, DevicePrefetcher, to_device
from salience_detr_torch.engine.train import evaluate
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.factory import build_salience_detr, exact_sampling
from salience_detr_torch.parallel.mesh import init_distributed, shutdown
from salience_detr_torch.parallel.train_step import make_eval_step
from salience_detr_torch.utils.coco_eval import CocoEvaluator
from salience_detr_torch.utils.env import configure_numerics
from salience_detr_torch.utils.logging_utils import setup_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser("Salience-DETR evaluation (PyTorch port)")
    p.add_argument("--coco-img", default="data/coco/val2017")
    p.add_argument("--coco-ann", default="data/coco/annotations/instances_val2017.json")
    p.add_argument("--model-config", default=str(DEFAULT_CONFIG))
    weights = p.add_mutually_exclusive_group()
    weights.add_argument("--torch-checkpoint", default=None,
                         help="upstream-layout .pth state dict, evaluated in exact per-head sampling mode")
    weights.add_argument("--checkpoint", default=None, help="state dict of the port's model for --model-config")
    p.add_argument("--result-file", default=None, help="re-score an existing predictions JSON")
    p.add_argument("--save-results", default=None, help="dump predictions JSON here")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0, help="init seed when no checkpoint is given")
    p.add_argument("--device", default="cuda", help="cuda (cuda:LOCAL_RANK under the launcher) or cpu")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="process group backend under the launcher (default nccl on cuda, gloo on cpu)")
    return p.parse_args(argv)


def rescore_result_file(coco: CocoIndex, result_file: str) -> Dict[str, float]:
    """COCO-result-format JSON -> the evaluator's 12 metrics, printed."""
    with open(result_file) as f:
        results = json.load(f)
    by_img = {}
    for r in results:
        by_img.setdefault(r["image_id"], {"boxes": [], "scores": [], "labels": []})
        x, y, w, h = r["bbox"]
        by_img[r["image_id"]]["boxes"].append([x, y, x + w, y + h])
        by_img[r["image_id"]]["scores"].append(r["score"])
        by_img[r["image_id"]]["labels"].append(r["category_id"])
    ev = CocoEvaluator(coco)
    ev.update({k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in by_img.items()})
    ev.accumulate()
    stats = ev.summarize()
    print(" ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    print(ev.per_category_table())
    return stats


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A saved state dict, or the ``"model"`` entry of a training checkpoint,
    without upstream Swin's attention buffers (which the port computes)."""
    from salience_detr_torch.weights import drop_unmapped_buffers

    state = torch.load(path, map_location="cpu", weights_only=True)
    return drop_unmapped_buffers(state.get("model", state))


def save_results(evaluator: CocoEvaluator, path: str) -> int:
    """The evaluator's predictions (xywh) as a COCO result JSON, image by
    image in id order (so that a data-parallel run's merged predictions
    write the same file as one process's); returns their count."""
    results = [
        {"image_id": int(img_id), "category_id": int(label), "bbox": [float(v) for v in box],
         "score": float(score)}
        for img_id, pred in sorted(evaluator.predictions.items(), key=lambda kv: int(kv[0]))
        for box, score, label in zip(pred["boxes"], pred["scores"], pred["labels"])
    ]
    with open(path, "w") as f:
        json.dump(results, f)
    return len(results)


def main(argv=None) -> Optional[Dict[str, float]]:
    args = parse_args(argv)
    if args.result_file:
        setup_logger()
        return rescore_result_file(CocoDetection(args.coco_img, args.coco_ann).coco, args.result_file)
    mesh = init_distributed(args.device, args.dist_backend)
    try:
        return evaluate_split(args, mesh)
    finally:
        shutdown(mesh)


def evaluate_split(args, mesh) -> Dict[str, float]:
    configure_numerics()
    logger = setup_logger(rank=mesh.rank)
    dataset = CocoDetection(args.coco_img, args.coco_ann)
    device = mesh.device
    cfg = load_config(args.model_config)
    if args.torch_checkpoint:
        cfg = exact_sampling(cfg)
        logger.info("torch-checkpoint eval: checkpoint-exact per-head sampling in encoder and decoder")
    model, postprocess = build_salience_detr(cfg, device, torch.Generator().manual_seed(args.seed))
    checkpoint = args.torch_checkpoint or args.checkpoint
    if checkpoint:
        model.load_state_dict(load_state_dict(checkpoint), strict=True)
        logger.info(f"Loaded {checkpoint}")

    evaluator = CocoEvaluator(dataset.coco)
    logger.info(f"COCO box matching route: {evaluator.route}")
    if mesh.distributed:
        logger.info(f"data parallel: {mesh.world} ranks, each evaluating its shard of the batches")
    loader = DevicePrefetcher(DetectionLoader(dataset, args.batch_size, rank=mesh.rank, world=mesh.world),
                              functools.partial(to_device, cfg=cfg), device)
    stats = evaluate(make_eval_step(model, postprocess, cfg.dtype), loader, evaluator, logger=logger,
                     all_gather_fn=mesh.all_gather_object if mesh.distributed else None)
    logger.info("kernel launches: " + " ".join(f"{k}={v}" for k, v in native.LAUNCHES.items() if v))
    if args.save_results and mesh.rank == 0:
        n = save_results(evaluator, args.save_results)
        logger.info(f"Saved {n} predictions to {args.save_results}")
    return stats


if __name__ == "__main__":
    main()
