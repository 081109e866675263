"""Training entry point of the port (root ``train.py``'s counterpart).

    python -m salience_detr_torch.train --config-file configs/salience_detr_torch/train_config.py
        [--mixed-precision {no,bf16,fp16}] [--seed S] [--accumulate-steps A]
        [--pretrained-backbone F] [--use-deterministic-algorithms]
        [--dry-run-steps N] [--model-config F] [--device cuda] [--dist-backend nccl|gloo]
    torchrun --nproc_per_node N -m salience_detr_torch.train --config-file F ...

Trains the model of the train config's ``model_path`` (or ``--model-config``)
on a COCO-format split: the ``train_transform`` preset (``strong_album``
included), copy-paste between the images of a batch when ``copypaste`` is
set (the dataset then loads instance masks), the fixed-canvas train
loader, AdamW with the config's parameter grouping, the warmup +
multi-step schedule (warmup capped at the steps of an epoch), clip
``max_norm``; after each epoch a checkpoint, the COCO evaluation of the test
split with the port's eval loader, and the best-AP/AP50 snapshots.
``resume_from_checkpoint`` resumes from the newest checkpoint in the output
directory (model, optimizer moments, schedule step, grad scaler and seed)
and starts at epoch step // steps_per_epoch, as the JAX ``train.py`` does: a
finished epoch is not trained again, an epoch cut short (a preemption, a
``--dry-run-steps`` run) is replayed; SIGTERM or SIGINT finishes the step in
flight, writes a checkpoint and exits 0.  Every epoch draws its
shuffle, augmentation and CDN streams from (seed, epoch), so a resumed epoch
is the epoch an unbroken run would have trained.  ``--mixed-precision bf16``
(the default) and ``fp16`` run the CUDA forward under autocast over float32
master weights, ``fp16`` with a ``torch.amp.GradScaler``.  ``--device``
defaults to ``cuda`` and the CLI raises when that device is missing;
``--device cpu`` runs everything on the CPU in float32.

Under the launcher (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) each process is one rank of a data-parallel
run (``parallel/mesh.py``, ``parallel/train_step.py``): ``--device cuda``
means ``cuda:LOCAL_RANK`` (it raises when that card is missing), the process
group is NCCL on the cards and gloo on the CPU (``--dist-backend`` overrides
it) and raises when it cannot form.  The config's ``batch_size`` is the
global batch; each rank loads, augments and trains its rows of it, and the
W ranks compute the one-process step on the global batch.  Rank 0 draws the
seed (when none is given) and names the output directory for every rank;
it alone writes the log file, the tracker's files, label_names.txt, the
checkpoints and the snapshots (the other ranks wait at a barrier after each
save), and every rank resumes from the same checkpoint.  Each rank evaluates
a shard of the test split and the predictions are merged before scoring, so
every rank holds the same stats.  A stop signal to any rank stops every rank
after the same step.  At the end rank 0 writes ``summary.json`` (the last
step's metrics averaged over the ranks, the metrics logged every
``print_freq`` steps, the last eval's stats, the global step, the seed and
rank 0's loader workers' seconds and samples) into the output directory.

    python -m salience_detr_torch.train --steps N [--seed S] [--model-config F]

trains on synthetic batches instead (CUDA only; ``Trainer``; under the
launcher each rank trains its rows of each batch): B=4 on the
800x1344 canvas, bf16 autocast, the optimizer settings of the train config
(warmup over the N steps), images uniform in [-2, 2] and per image 24, 7, 40
and 1 gt boxes with random labels, centres uniform in [0.25, 0.7] and sizes
in [0.05, 0.25], padded to ``max_gt`` = 100.  Prints one JSON line with the
last step's metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import itertools
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from salience_detr_torch.engine.optim import build_optimizer, make_lr_schedule
from salience_detr_torch.engine.train import evaluate, train_one_epoch
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.bricks.criterion import Targets, default_weight_dict
from salience_detr_torch.models.factory import SalienceDETRConfig, build_criteria, build_salience_detr
from salience_detr_torch.parallel.mesh import Mesh, init_distributed, mean_over_ranks, shard_batch, shutdown
from salience_detr_torch.parallel.train_step import make_eval_step, make_train_step
from salience_detr_torch.utils.config import Config

TRAIN_CONFIG = Path(__file__).resolve().parent.parent / "configs" / "salience_detr_torch" / "train_config.py"
GT_COUNTS = (24, 7, 40, 1)  # valid gts per image of a synthetic batch of 4
DTYPES = {"no": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


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
    from a seed; ``generator`` draws the CDN noise on the device.  With a
    distributed ``mesh`` it is one rank of a data-parallel run: every rank
    builds the same model and batches from the seed and trains its rows of
    each batch."""

    def __init__(self, cfg: SalienceDETRConfig, device, seed: int = 0, steps_per_epoch: int = 1,
                 train_cfg: Optional[Dict] = None, mesh: Optional[Mesh] = None):
        tc = train_cfg or Config(str(TRAIN_CONFIG)).to_dict()
        self.cfg, self.device, self.mesh = cfg, torch.device(device), mesh
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
            cfg.dtype if amp else None, mesh=mesh,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def batches(self, steps: int, seed: int, counts: Sequence[int] = GT_COUNTS) -> Iterator[Dict]:
        """``steps`` synthetic batches (the rank's rows of each in a
        data-parallel run)."""
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            batch = synthetic_batch(rng, self.cfg.num_classes, counts, self.canvas, self.max_gt, self.device)
            yield shard_batch(batch, self.mesh) if self.mesh is not None and self.mesh.distributed else batch


def parse_args(argv=None):
    p = argparse.ArgumentParser("Salience-DETR training (PyTorch port)")
    p.add_argument("--config-file", default=str(TRAIN_CONFIG))
    p.add_argument("--mixed-precision", default="bf16", choices=sorted(DTYPES),
                   help="compute dtype of the CUDA forward (autocast over float32 master weights); "
                        "fp16 adds a GradScaler")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--accumulate-steps", type=int, default=1,
                   help="micro-batches per optimizer step; the batch size must be divisible by it")
    p.add_argument("--pretrained-backbone", default=None,
                   help="ImageNet .pth (torchvision names) loaded into the backbone; overrides the "
                        "config's backbone_weights")
    p.add_argument("--use-deterministic-algorithms", action="store_true",
                   help="torch.use_deterministic_algorithms (warn only) for the library ops")
    p.add_argument("--dry-run-steps", type=int, default=0, help="stop after N steps of one epoch")
    p.add_argument("--model-config", default=None, help="model config file in place of the config's model_path")
    p.add_argument("--device", default="cuda", help="cuda (cuda:LOCAL_RANK under the launcher) or cpu")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="process group backend under the launcher (default nccl on cuda, gloo on cpu)")
    p.add_argument("--steps", type=int, default=None,
                   help="train N steps on synthetic batches instead (CUDA only)")
    return p.parse_args(argv)


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's CDN generator: each epoch draws a fresh stream,
    and a resumed epoch E replays E's stream."""
    return ((seed + 7) * 1_000_003 + epoch) % (2**63)


def model_state(model) -> Dict[str, torch.Tensor]:
    """The model's state dict (the upstream layout) on the host."""
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def checkpoint_state(model, optimizer, step, scaler, epoch: int, seed: int) -> Dict:
    return {
        "model": model_state(model),
        "optimizer": optimizer.state_dict(),
        "step": step.steps_done,
        "epoch": epoch,
        "scaler": scaler.state_dict() if scaler is not None else None,
        "rng": {"seed": seed},
    }


def train_coco(args) -> Dict:
    """The COCO-format training run of ``args``; returns a summary (the
    epochs run, the global step, the last step's metrics and the last eval's
    stats, the output directory, the epoch it started from, the train loop's
    wait for each batch and the workers' transform seconds)."""
    mesh = init_distributed(args.device, args.dist_backend)
    try:
        return _train_coco(args, mesh)
    finally:
        shutdown(mesh)


def _train_coco(args, mesh: Mesh) -> Dict:
    from salience_detr_torch.data.coco import CocoDetection
    from salience_detr_torch.data.loader import DetectionLoader, DevicePrefetcher, TrainLoader, to_device, train_to_device
    from salience_detr_torch.data.transforms import build_preset, simple_copy_paste
    from salience_detr_torch.utils.checkpoint import CheckpointManager, HighestCheckpoint
    from salience_detr_torch.utils.coco_eval import CocoEvaluator
    from salience_detr_torch.utils.coco_utils import get_coco_index_from_dataset
    from salience_detr_torch.utils.env import GracefulShutdown, collect_env_info, seed_everything
    from salience_detr_torch.utils.logging_utils import setup_logger
    from salience_detr_torch.utils.tracker import NullTracker, TensorBoardTracker
    from salience_detr_torch.weights import load_backbone_weights, load_finetune_weights

    device, lead = mesh.device, mesh.rank == 0
    cfg = Config(args.config_file)
    model_path = args.model_config or cfg.model_path
    dtype = DTYPES[args.mixed_precision]
    model_cfg = dataclasses.replace(load_config(model_path), dtype=dtype)
    amp = device.type == "cuda" and dtype != torch.float32
    if args.use_deterministic_algorithms:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)

    model_name = os.path.splitext(os.path.basename(model_path))[0]
    output_dir = mesh.broadcast_object(cfg.get("output_dir") or os.path.join(
        "checkpoints", model_name, "train", datetime.datetime.now().strftime("%Y-%m-%d-%H_%M_%S")))
    logger = setup_logger(output=output_dir if lead else None, rank=mesh.rank)
    if mesh.distributed:
        logger.info(f"data parallel: {mesh.world} ranks, {device} on rank 0, global batch {cfg.batch_size}")
    logger.info(f"Command: {' '.join(sys.argv)}")
    logger.info(f"Config:\n{cfg.pretty()}")

    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"))
    restored = ckpt.restore() if cfg.get("resume_from_checkpoint") else None
    seed = args.seed
    if restored is not None:
        if seed is not None and seed != restored["rng"]["seed"]:
            logger.warning(f"--seed {seed} differs from the checkpoint's {restored['rng']['seed']}: "
                           "the resumed epochs draw other streams than an unbroken run")
        seed = restored["rng"]["seed"] if seed is None else seed
    seed = seed_everything(mesh.broadcast_object(seed_everything(seed) if lead else None))
    logger.info(f"Environment:\n{collect_env_info()}")
    logger.info(f"seed={seed}")

    # copy-paste composites by instance masks: the dataset loads them and
    # the loader runs it on each pooled batch
    use_copypaste = bool(cfg.get("copypaste", False))
    train_dataset = CocoDetection(cfg.train_img_folder, cfg.train_ann_file,
                                  transforms=build_preset(cfg.get("train_transform", "detr")), train=True,
                                  return_masks=use_copypaste)
    test_dataset = CocoDetection(cfg.test_img_folder, cfg.test_ann_file)
    num_workers = cfg.get("num_workers", 8)
    train_loader = TrainLoader(
        train_dataset, cfg.batch_size, canvas_hw=tuple(cfg.get("train_canvas", (800, 1344))),
        max_gt=cfg.get("max_gt", 100), shuffle=True, seed=seed, num_workers=num_workers,
        batch_transform=simple_copy_paste if use_copypaste else None,
        rank=mesh.rank, world=mesh.world, accumulate_steps=args.accumulate_steps,
    )
    test_loader = DetectionLoader(test_dataset, cfg.batch_size, num_workers, mesh.rank, mesh.world)
    steps_per_epoch = len(train_loader)

    names = {c["id"]: c["name"] for c in train_dataset.coco.cats.values()}
    if lead:
        with open(os.path.join(output_dir, "label_names.txt"), "w") as f:
            for i in range(max(names, default=0) + 1):
                f.write(names.get(i, str(i)) + "\n")

    model, postprocess = build_salience_detr(model_cfg, device, torch.Generator().manual_seed(seed))
    criterion, salience_criterion = build_criteria(model_cfg)
    backbone_weights = args.pretrained_backbone or cfg.get("backbone_weights")
    if backbone_weights:
        load_backbone_weights(model, backbone_weights, logger)
    if cfg.get("finetune_weights"):
        load_finetune_weights(model, cfg.finetune_weights, logger)
    optimizer = build_optimizer(
        model, cfg.learning_rate, cfg.get("weight_decay", 1e-4), tuple(cfg.get("betas", (0.9, 0.999))),
        grouping=cfg.get("param_dicts", "finetune_backbone_and_linear_projection"),
    )
    schedule = make_lr_schedule(
        cfg.learning_rate, steps_per_epoch, milestones=cfg.get("lr_milestones", [10]),
        gamma=cfg.get("lr_gamma", 0.1), warmup_factor=cfg.get("warmup_factor", 1e-3),
        warmup_steps=min(cfg.get("warmup_steps", 1000), steps_per_epoch),
    )
    scaler = torch.amp.GradScaler(device.type) if amp and dtype == torch.float16 else None
    step = make_train_step(
        model, criterion, salience_criterion, optimizer, schedule,
        default_weight_dict(model_cfg.num_decoder_layers), cfg.get("max_norm", 0.1),
        dtype if amp else None, accumulate_steps=args.accumulate_steps, scaler=scaler, mesh=mesh,
    )
    eval_step = make_eval_step(model, postprocess, model_cfg.dtype)

    starting_epoch = cfg.get("starting_epoch", 0)
    global_step = 0
    if restored is not None:
        model.load_state_dict(restored["model"], strict=True)
        optimizer.load_state_dict(restored["optimizer"])
        if scaler is not None and restored["scaler"] is not None:
            scaler.load_state_dict(restored["scaler"])
        step.steps_done = global_step = restored["step"]
        starting_epoch = restored["step"] // max(steps_per_epoch, 1)
        logger.info(f"Resumed from epoch {restored['epoch']} (step {restored['step']}) at epoch {starting_epoch}")

    best = HighestCheckpoint(ckpt)
    tracker = TensorBoardTracker(output_dir) if lead else NullTracker()
    gather = mesh.all_gather_object if mesh.distributed else None
    metadata = {"class_names": names, "model_path": model_path, "seed": seed}
    summary = {"output_dir": output_dir, "seed": seed, "starting_epoch": starting_epoch, "epochs": [],
               "steps_per_epoch": steps_per_epoch, "loader_waits_s": [], "stats": None, "metrics": {},
               "logged": []}

    def log_train(values: Dict[str, float], at: int):
        """The tracker's train lines, also kept for the summary (fetched
        every print_freq steps, averaged over the ranks)."""
        summary["logged"].append({"step": at, **{k[len("loss/"):]: v for k, v in values.items()}})
        tracker.log(values, at)

    try:
        with GracefulShutdown(logger=logger) as stop:
            step.stop_source = stop
            for epoch in range(starting_epoch, cfg.num_epochs):
                train_loader.set_epoch(epoch)
                prefetcher = DevicePrefetcher(train_loader, train_to_device, device)
                batches = iter(prefetcher)
                generator = torch.Generator(device).manual_seed(epoch_seed(seed, epoch))
                try:
                    global_step, metrics = train_one_epoch(
                        step, itertools.islice(batches, args.dry_run_steps) if args.dry_run_steps else batches,
                        generator, epoch, cfg.get("print_freq", 50), global_step, logger, log_train,
                        step.should_stop,
                    )
                finally:
                    batches.close()
                summary["loader_waits_s"] += prefetcher.waits
                summary["metrics"] = {k: float(v) for k, v in mean_over_ranks(metrics).items()}
                summary["epochs"].append(epoch)
                if lead:
                    ckpt.save(epoch, checkpoint_state(model, optimizer, step, scaler, epoch, seed),
                              metadata)
                mesh.barrier()
                if step.should_stop():
                    logger.warning(f"preemption checkpoint saved at epoch {epoch} (step {step.steps_done}); "
                                   "exiting")
                    break
                evaluator = CocoEvaluator(get_coco_index_from_dataset(test_dataset))
                stats = evaluate(eval_step, DevicePrefetcher(test_loader, functools.partial(to_device, cfg=model_cfg), device), evaluator,
                                 logger=logger, tracker=tracker.log, epoch=epoch, all_gather_fn=gather)
                summary["stats"] = stats
                if lead:
                    best.update({"model": model_state(model), "epoch": epoch, "step": step.steps_done},
                                stats["AP"], stats["AP50"])
                mesh.barrier()
                if args.dry_run_steps:
                    break
    finally:
        tracker.close()
    summary.update(global_step=global_step, transform_s=train_loader.transform_s, samples=train_loader.samples)
    if lead:
        with open(os.path.join(output_dir, "summary.json"), "w") as f:
            json.dump({k: summary[k] for k in ("metrics", "logged", "stats", "global_step", "seed", "epochs",
                                               "transform_s", "samples")}, f)
    logger.info("Training done")
    return summary


def train_synthetic(args) -> Dict:
    if not torch.cuda.is_available():
        raise SystemExit("salience_detr_torch.train --steps needs a CUDA device")
    mesh = init_distributed("cuda", args.dist_backend)
    try:
        logging.basicConfig(level=logging.INFO if mesh.rank == 0 else logging.WARNING,
                            format="%(asctime)s %(message)s")
        cfg = load_config(args.model_config or DEFAULT_CONFIG)
        trainer = Trainer(cfg, str(mesh.device), args.seed or 0, steps_per_epoch=args.steps, mesh=mesh)
        t0 = time.perf_counter()
        steps, metrics = train_one_epoch(
            trainer.step, trainer.batches(args.steps, args.seed or 0), trainer.generator, 0,
            trainer.print_freq,
        )
        metrics = mean_over_ranks(metrics)
        torch.cuda.synchronize()
        result = {"steps": steps, "seconds": time.perf_counter() - t0, "ranks": mesh.world,
                  "device": torch.cuda.get_device_name(mesh.device)}
        result.update({k: float(v) for k, v in metrics.items()})
        if mesh.rank == 0:
            print(json.dumps(result))
        return result
    finally:
        shutdown(mesh)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if args.steps is not None:
        return train_synthetic(args)
    return train_coco(args)


if __name__ == "__main__":
    main()
