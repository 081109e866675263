"""What the port's user tools share: the flags that name the model (the
card unless ``--device cpu``), the model itself through the serving
``Predictor``, a folder of images through the eval geometry, and a
``Trainer`` with its synthetic batches at a chosen canvas.

Imports torch, numpy and the port only."""

from __future__ import annotations

import argparse
from typing import Dict, Iterator, Optional, Tuple

import torch

from salience_detr_torch.inference import DEFAULT_CONFIG, Predictor, letterbox, load_config
from salience_detr_torch.models.detectors.salience_detr import normalize_images
from salience_detr_torch.models.factory import SalienceDETRConfig


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model-config", default=str(DEFAULT_CONFIG))
    p.add_argument("--checkpoint", default=None,
                   help="the port's state dict (.pth), or a training checkpoint holding one under 'model'")
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--seed", type=int, default=0, help="init seed when no checkpoint is given")


def load_model(args: argparse.Namespace, cfg: Optional[SalienceDETRConfig] = None) -> Predictor:
    """The ``Predictor`` that ``add_model_args`` names (``cfg`` in place of
    the config file): its model, in eval mode on the device, loaded strictly
    from the checkpoint or initialized from the seed, its ``postprocess``
    and ``cfg``, with the numerics of the port's CLIs."""
    from salience_detr_torch.test import load_state_dict

    cfg = cfg if cfg is not None else load_config(args.model_config)
    state = load_state_dict(args.checkpoint) if args.checkpoint else None
    return Predictor(cfg, state, args.device, args.seed)


def folder_batches(image_dir: str, cfg: SalienceDETRConfig, device, limit: Optional[int] = None
                   ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """(path, batch of one image) for the first ``limit`` images of a folder
    (``data.coco.InferenceDataset``): the uint8 canvas ``canvas`` (1, 3, H,
    W), ``images`` normalized, ``image_sizes`` and ``orig_sizes``."""
    from salience_detr_torch.data.coco import InferenceDataset

    dataset = InferenceDataset(image_dir)
    for i in range(len(dataset) if limit is None else min(limit, len(dataset))):
        canvas, sizes, orig = letterbox([dataset[i]["image"]], cfg, device)
        yield dataset.paths[i], {"canvas": canvas, "images": normalize_images(canvas.float() / 255.0),
                                 "image_sizes": sizes, "orig_sizes": orig}


def synthetic_trainer(cfg: SalienceDETRConfig, device, steps: int, batch: int = 4,
                      canvas: Optional[Tuple[int, int]] = None, mesh=None):
    """A ``Trainer`` of ``cfg`` from seed 0 (``steps`` steps an epoch, the
    train config's canvas unless ``canvas``) and its first ``steps``
    synthetic batches of ``batch`` images (the gt counts ``GT_COUNTS``
    cycled; a data-parallel rank's rows of them with ``mesh``)."""
    from salience_detr_torch.train import GT_COUNTS, TRAIN_CONFIG, Trainer
    from salience_detr_torch.utils.config import Config

    train_cfg = Config(str(TRAIN_CONFIG)).to_dict()
    if canvas:
        train_cfg["train_canvas"] = list(canvas)
    trainer = Trainer(cfg, device, seed=0, steps_per_epoch=steps, train_cfg=train_cfg, mesh=mesh)
    counts = [GT_COUNTS[i % len(GT_COUNTS)] for i in range(batch)]
    return trainer, list(trainer.batches(steps, seed=0, counts=counts))
