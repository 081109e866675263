#!/usr/bin/env python3
"""Where the time of the PyTorch port's eval forward and train step goes, on
one CUDA card.

    python tools/profile_torch_slice.py [--model-config F] [--backbone NAME] [--no-train] [--out FILE.json]

Builds the model of ``--model-config`` (the flagship R50 by default; with
``--backbone``, that config with another backbone arch; random weights from
seed 0, bf16 autocast),
serves one batch of 4 landscape requests padded to the 800x1344 canvas, and
reports for that forward (top-level keys) and, under "train", for the train
step of ``salience_detr_torch.train.Trainer`` on synthetic B=4 800x1344
batches (steps in place of forwards, plus the peak device memory):

* wall ms per forward: host clock around ``Predictor.forward`` (model and
  post-processing) ending in a synchronisation, profiler off, median of 5,
  and all 5;
* device ms per forward: the sum of the durations of the device activities
  that ``torch.profiler`` (device tracing only) records over 5 more forwards;
* host ms per profiled forward, the same clock around those 5 forwards.
  Tracing adds host time to every launch of this launch-bound forward, so
  the device window inside the profiler is not the window without it;
* the device idle share: 1 - device ms / wall ms, at the median wall time
  and at the fastest and slowest of the 5 (the host's speed varies);
* device ms per forward by category of kernel name, and the top kernels;
* the peak device memory of the profiled forwards (and steps).

``--no-train`` skips the train step; ``MSDA_GATHER_QUANT=int8`` in the
environment profiles the int8 encoder sampling of the eval forward.  Prints
one JSON line (also written to ``--out`` when given).  Fails without a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from salience_detr_torch.inference import DEFAULT_CONFIG, Predictor, load_config, preprocess  # noqa: E402
from salience_detr_torch.tools.trace_report import category  # noqa: E402
from salience_detr_torch.train import Trainer  # noqa: E402

BATCH = 4
ITERS = 5
SEED = 0


def measure(run, iters: int):
    """Host-clock ms of ``iters`` calls of ``run`` (profiler off), then the
    device activities of ``iters`` more under device-only tracing."""
    wall = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(wall)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name[e.name]
            entry[0] += e.time_range.elapsed_us() / 1e3 / iters
            entry[1] += 1
    by_cat = defaultdict(float)
    for name, (ms, _) in by_name.items():
        by_cat[category(name)] += ms
    device_ms = sum(by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    return {
        "wall_ms_per_forward": wall_ms,
        "wall_ms_all": wall,
        "profiled_wall_ms_per_forward": profiled_wall_ms,
        "device_ms_per_forward": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "device_idle_share_fastest_slowest": [1.0 - device_ms / min(wall), 1.0 - device_ms / max(wall)],
        "kernels_per_forward": sum(n for _, n in by_name.values()) / iters,
        "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": name[:120], "ms_per_forward": ms, "launches_per_forward": n / iters}
            for name, (ms, n) in top
        ],
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--model-config", default=str(DEFAULT_CONFIG))
    p.add_argument("--backbone", default=None, help="another backbone arch for the config")
    p.add_argument("--no-train", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_slice: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    cfg = load_config(args.model_config)
    if args.backbone:
        cfg = dataclasses.replace(cfg, backbone=args.backbone)
    predictor = Predictor(cfg, None, "cuda", seed=SEED)
    rng = np.random.default_rng(SEED)
    sizes = [(480, 640), (800, 1200), (600, 600), (720, 1280)]
    requests = [
        rng.integers(0, 256, size=(*sizes[i % len(sizes)], 3), dtype=np.uint8)
        for i in range(BATCH)
    ]
    inputs = preprocess(requests, cfg, "cuda")
    for _ in range(2):
        predictor.forward(*inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    report = {"card": card, "config": Path(args.model_config).name, "backbone": cfg.backbone, "batch": BATCH,
              "canvas": list(inputs[0].shape[-2:]), "msda_gather_quant": os.environ.get("MSDA_GATHER_QUANT", "none")}
    report.update(measure(lambda: predictor.forward(*inputs), ITERS))
    report["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del predictor
    torch.cuda.empty_cache()
    if args.no_train:
        return finish(report, args.out)

    # the train step: warm-up, then steps on one batch (a fresh batch per
    # step would add host time that the step itself does not spend)
    trainer = Trainer(cfg, "cuda", seed=SEED, steps_per_epoch=1000)
    batch = next(trainer.batches(1, seed=SEED))
    for _ in range(2):
        trainer.step(batch, trainer.generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train = measure(lambda: trainer.step(batch, trainer.generator), ITERS)
    train["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["train"] = {k.replace("_per_forward", "_per_step"): v for k, v in train.items()}
    finish(report, args.out)


def finish(report, out):
    line = json.dumps(report)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
