"""Serve and train the large-backbone configs at the real canvas and report
their speed, MFU, memory and largest serve batch (the twin of the JAX tool
``tools/backbone_bench.py``).

    python -m salience_detr_torch.tools.backbone_bench [--configs swin_l convnext_l focalnet_large_lrf
        resnet50_5scale] [--batch 2] [--train-batch 1] [--iters 6] [--max-batch 16] [--skip-train]
        [--out F.json] [--device cuda|cpu]

Per config (``configs/salience_detr_torch/``; random weights from seed 0,
bf16 autocast, seeded uniform images filling the 800x1344 canvas):

* serve img/s: ``--batch`` images over the median of ``--iters`` eval
  forwards, each timed by CUDA events after a warm-up;
* train img/s: ``--train-batch`` images over the median of ``--iters``
  ``Trainer`` steps (forward, CDN, assignment, losses, backward, AdamW),
  each timed by CUDA events after a warm-up;
* FLOPs of a forward and of a step from ``FlopCounterMode``
  (``tools/benchmark_model.py``: convolutions, GEMMs, dense attention and
  the MSDA forward by its registered formula; element-wise ops, norms and
  the MSDA backward not counted; a grouped convolution's backward with its
  weight gradient divided by the groups, :func:`grouped_conv_backward_flop`),
  and MFU: FLOPs over the median time over
  the card's dense bf16 peak (:data:`PEAK_TFLOPS`, named in the JSON with
  the card's name and power limit);
* peak memory of a forward and of a step (``max_memory_allocated``);
* the largest serve batch that runs, doubling from ``--batch`` up to
  ``--max-batch`` (0: no bound).  Only ``torch.cuda.OutOfMemoryError``
  ends the probe; any other error propagates.

Prints one JSON line a config; ``--out`` also writes them all to a file
(merged with a file already there, by config).  What differs from the JAX
tool: times by CUDA events, not a chained loop on the host clock; FLOPs by
``FlopCounterMode``, not XLA's cost analysis; peak memory measured, not the
compiled program's estimate; one program a model (the JAX tool's
``--split`` worked round its TPU compiler); the batch probe counts only an
out-of-memory error (the JAX tool counts any exception, ``ADVICE.md``);
R50 5-scale in place of the flagship R50; it runs on the card unless
``--device cpu`` is given (host clock, no peak memory).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from salience_detr_torch.inference import load_config
from salience_detr_torch.tools.quality import REPO, platform, require_device

CONFIG_DIR = REPO / "configs" / "salience_detr_torch"
CONFIGS = {
    "swin_l": "salience_detr_swin_l_800_1333.py",
    "convnext_l": "salience_detr_convnext_l_800_1333.py",
    "focalnet_large_lrf": "salience_detr_focalnet_large_lrf_800_1333.py",
    "resnet50_5scale": "salience_detr_resnet50_5scale_800_1333.py",
}
# NVIDIA's data sheet, H100 SXM, dense bf16 on the tensor cores, at 700 W
PEAK_TFLOPS = 989.0
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense bf16 (tensor cores), at a 700 W power limit"


def grouped_conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
                               output_padding, groups, output_mask, out_shape) -> int:
    """``torch.utils.flop_counter``'s count of a convolution's backward with
    its weight-gradient term divided by ``groups``: torch counts that term
    as a dense convolution over all the input's channels, so a depthwise
    convolution's (ConvNeXt's, FocalNet's) weight gradient counted
    ``groups`` times over (torch 2.11, 2.13)."""
    from torch.utils import flop_counter

    count = flop_counter.conv_backward_flop.__wrapped__  # the formula on shapes, as registered
    args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed, output_padding, groups)
    inputs = count(*args, [output_mask[0], False, False], out_shape)
    weight = count(*args, [False, output_mask[1], False], out_shape)
    return inputs + weight // groups


def step_flop_counter():
    """``FlopCounterMode`` for a train step, with the grouped convolution
    backward counted by :func:`grouped_conv_backward_flop`."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.convolution_backward: grouped_conv_backward_flop})


def probe_max_batch(forward_at: Callable[[int], None], batch: int, max_batch: int) -> Tuple[int, Optional[int]]:
    """The largest batch at which ``forward_at`` runs, doubling from
    ``batch`` (which has run) while at most ``max_batch`` (0: no bound);
    returns it and the batch that ran out of memory (None when the bound
    ended the probe).  Only ``torch.cuda.OutOfMemoryError`` ends it: any
    other error propagates."""
    ok, b = batch, batch * 2
    while not max_batch or b <= max_batch:
        try:
            forward_at(b)
        except torch.cuda.OutOfMemoryError:
            return ok, b
        ok, b = b, b * 2
    return ok, None


class Clock:
    """Milliseconds of one call: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.device = device

    def ms(self, fn: Callable[[], object]) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end)

    def peak(self, fn: Callable[[], object]) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        fn()
        torch.cuda.synchronize(self.device)
        return torch.cuda.max_memory_allocated(self.device)


def images_at(batch: int, canvas, device, seed: int = 0):
    H, W = canvas
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(-2, 2, (batch, 3, H, W)).astype(np.float32)).to(device)
    return images, torch.tensor([[H, W]] * batch, device=device)


def mfu(flops: int, ms: float, device: torch.device) -> Dict[str, Optional[float]]:
    """Achieved TFLOP/s and, on the card, its share of the card's peak."""
    tflops = flops / (ms * 1e-3) / 1e12
    return {"tflops": tflops, "mfu_pct": 100.0 * tflops / PEAK_TFLOPS if device.type == "cuda" else None}


def bench_serve(cfg, device: torch.device, batch: int, canvas, iters: int, max_batch: int) -> Dict:
    from salience_detr_torch.models.factory import build_salience_detr
    from salience_detr_torch.parallel.train_step import eval_autocast
    from salience_detr_torch.tools.benchmark_model import count_parameters, forward_flops

    model, _ = build_salience_detr(cfg, device, torch.Generator().manual_seed(0))
    clock = Clock(device)

    def forward(images, sizes):
        with torch.no_grad(), eval_autocast(device, cfg.dtype):
            return model(images, sizes)["pred_class"][-1]

    images, sizes = images_at(batch, canvas, device)
    flops = forward_flops(model, images, sizes, eval_autocast(device, cfg.dtype))["total"]
    forward(images, sizes)  # warm-up
    times = [clock.ms(lambda: forward(images, sizes)) for _ in range(iters)]
    ms = statistics.median(times)
    rec = {"params": count_parameters(model), "batch": batch, "serve_ms": ms, "serve_ms_all": times,
           "serve_img_s": batch / (ms * 1e-3), "serve_flops": flops, "serve": mfu(flops, ms, device),
           "serve_peak_bytes": clock.peak(lambda: forward(images, sizes))}
    del images, sizes

    def forward_at(b):
        x, s = images_at(b, canvas, device)
        try:
            forward(x, s)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            del x, s
            if device.type == "cuda":
                torch.cuda.empty_cache()

    rec["max_serve_batch"], rec["oom_at_batch"] = probe_max_batch(forward_at, batch, max_batch)
    rec["max_batch_bound"] = max_batch or None
    return rec


def bench_train(cfg, device: torch.device, batch: int, canvas, iters: int) -> Dict:
    from salience_detr_torch.tools.common import synthetic_trainer

    trainer, batches = synthetic_trainer(cfg, device, iters + 2, batch, canvas)
    clock = Clock(device)
    mode = step_flop_counter()
    with mode:
        trainer.step(batches[0], trainer.generator)  # the warm-up step, counted
    flops = int(mode.get_total_flops())
    times = [clock.ms(lambda b=b: trainer.step(b, trainer.generator)) for b in batches[1:iters + 1]]
    ms = statistics.median(times)
    return {"train_batch": batch, "train_ms": ms, "train_ms_all": times, "train_img_s": batch / (ms * 1e-3),
            "train_flops": flops, "train": mfu(flops, ms, device),
            "train_peak_bytes": clock.peak(lambda: trainer.step(batches[-1], trainer.generator))}


def bench_config(name: str, device: torch.device, batch: int, train_batch: int, canvas, iters: int,
                 max_batch: int, skip_train: bool) -> Dict:
    cfg = dataclasses.replace(load_config(CONFIG_DIR / CONFIGS[name]), dtype=torch.bfloat16)
    rec = {"config": name, "canvas": list(canvas), **bench_serve(cfg, device, batch, canvas, iters, max_batch)}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not skip_train:
        rec.update(bench_train(cfg, device, train_batch, canvas, iters))
    return rec


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", nargs="*", default=list(CONFIGS), choices=list(CONFIGS))
    p.add_argument("--batch", type=int, default=2, help="serve batch")
    p.add_argument("--train-batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--max-batch", type=int, default=16, help="the batch probe's bound (0: double until OOM)")
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--out", default=None, help="also write the records here (merged by config)")
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = require_device(args.device)
    card = None
    if device.type == "cuda":
        from salience_detr_torch.timing import card_line
        from salience_detr_torch.utils.env import configure_numerics

        configure_numerics()
        card = card_line()
    records = []
    for name in args.configs:
        t0 = time.perf_counter()
        rec = bench_config(name, device, args.batch, args.train_batch, (args.height, args.width), args.iters,
                           args.max_batch, args.skip_train)
        rec.update(device=platform(device), card=card, seconds=time.perf_counter() - t0)
        if device.type == "cuda":
            rec.update(peak_tflops=PEAK_TFLOPS, peak_source=PEAK_SOURCE)
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        out = Path(args.out)
        old = json.loads(out.read_text())["results"] if out.exists() else []
        names = {r["config"] for r in records}
        out.write_text(json.dumps({"results": [r for r in old if r["config"] not in names] + records}, indent=1))
    return records


if __name__ == "__main__":
    main()
