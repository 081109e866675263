"""Model benchmark: parameters, FLOPs a forward, peak memory and latency of
the eval forward (the twin of the JAX tool ``tools/benchmark_model.py``, with
its flags and defaults: the flagship config, an 800x1344 canvas, batch 1,
20 repeats, bf16).

    python -m salience_detr_torch.tools.benchmark_model [--model-config F]
        [--height 800] [--width 1344] [--batch 1] [--repeats 20] [--no-bf16] [--device cuda|cpu]

* parameters: every parameter of the eval forward, as the JAX tool counts
  its eval init's ``params`` collection (the frozen convolutions included;
  neither buffers such as the frozen BatchNorms' statistics nor the
  train-only denoising table);
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one forward:
  convolutions, GEMMs, the dense attention, and the MSDA kernel's operator
  by its formula (``ops.deform_attn.ms_deform_attn_flops``: the plain
  version's corner multiply-adds); element-wise ops, norms, sorts, the
  grid NMS and the bilinear weights' arithmetic are not counted;
* peak memory: ``torch.cuda.max_memory_allocated`` over one forward;
* latency: CUDA events around ``--repeats`` forwards after a warm-up, and
  images a second.

The forward is the eval step's (autocast to bf16 on the card with
``--bf16``, the default) on seeded normal images filling the canvas, and
ends at the last decoder layer's logits and boxes, as the JAX tool's does.
It runs on the card unless ``--device cpu`` is given; there the latency is
the host's wall clock and the peak memory is not measured.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import defaultdict
from typing import Dict

import torch
from torch import nn

from salience_detr_torch.inference import load_config
from salience_detr_torch.parallel.train_step import eval_autocast
from salience_detr_torch.tools.common import add_model_args, load_model

# operator name prefixes -> what the FLOP count reports them as
FLOP_GROUPS = (
    ("convolution", ("aten.convolution", "aten._convolution")),
    ("matmul", ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm", "aten.matmul")),
    ("attention", ("aten._scaled_dot_product",)),
    ("ms_deform_attn", ("salience_detr.ms_deform_attn",)),
)


def count_parameters(model: nn.Module) -> int:
    """The eval forward's parameters (the train-only denoising table left
    out), as the JAX tool counts its eval init's ``params``."""
    return sum(p.numel() for n, p in model.named_parameters() if not n.startswith("denoising_generator."))


def forward_flops(model: nn.Module, images: torch.Tensor, sizes: torch.Tensor, autocast) -> Dict[str, int]:
    """FLOPs of one forward by operator group (:data:`FLOP_GROUPS`) and
    their ``total``, from ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    # with no parameter requiring a gradient: the counter's module tracker
    # hooks the backward of every module input that requires one
    requires = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    try:
        with torch.no_grad(), autocast, mode:
            model(images, sizes)
    finally:
        for p, r in zip(model.parameters(), requires):
            p.requires_grad_(r)
    by_group: Dict[str, int] = defaultdict(int)
    for op, n in mode.get_flop_counts()["Global"].items():
        name = str(op)
        group = next((g for g, prefixes in FLOP_GROUPS if name.startswith(prefixes)), name)
        by_group[group] += int(n)
    return {"total": int(mode.get_total_flops()), **by_group}


def benchmark(model: nn.Module, cfg, batch: int, height: int, width: int, repeats: int, seed: int = 0) -> Dict:
    """Parameters, FLOPs by group, peak bytes (None off the card), the
    latency (ms a forward) and images a second of the eval forward at this
    batch and canvas, on the model's device."""
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((batch, 3, height, width), generator=gen).to(device)
    sizes = torch.tensor([[height, width]] * batch, dtype=torch.int64, device=device)
    model.eval()

    def forward():
        with torch.no_grad(), eval_autocast(device, cfg.dtype):
            out = model(images, sizes)
        return out["pred_class"][-1], out["pred_coord"][-1]

    flops = forward_flops(model, images, sizes, eval_autocast(device, cfg.dtype))
    forward()  # warm-up
    on_card = device.type == "cuda"
    peak = None
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        forward()
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            forward()
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / repeats
    else:
        t0 = time.perf_counter()
        for _ in range(repeats):
            forward()
        ms = 1e3 * (time.perf_counter() - t0) / repeats
    return {"params": count_parameters(model), "flops": flops, "peak_bytes": peak, "ms": ms,
            "img_per_s": batch / (ms / 1e3), "device": torch.cuda.get_device_name(device) if on_card else "cpu"}


def report(r: Dict, batch: int) -> str:
    groups = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in r["flops"].items() if k != "total")
    peak = f"{r['peak_bytes'] / 2**30:.3f} GiB" if r["peak_bytes"] is not None else "not measured (CPU)"
    clock = "CUDA events" if r["peak_bytes"] is not None else "host wall clock, CPU"
    return "\n".join([
        f"device:        {r['device']}",
        f"params:        {r['params'] / 1e6:.2f} M",
        f"flops/forward: {r['flops']['total'] / 1e9:.2f} GFLOPs (FlopCounterMode: {groups} GFLOPs; element-wise "
        f"ops, norms, sorts, the grid NMS and the bilinear weights not counted)",
        f"peak memory:   {peak}",
        f"latency:       {r['ms']:.2f} ms / batch{batch}  ({r['img_per_s']:.2f} img/s; {clock})",
    ])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="the forward under bf16 autocast on the card (the default), else the config's dtype")
    args = p.parse_args(argv)
    cfg = load_config(args.model_config)
    if args.bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model = load_model(args, cfg).model
    print(report(benchmark(model, cfg, args.batch, args.height, args.width, args.repeats), args.batch))


if __name__ == "__main__":
    main()
