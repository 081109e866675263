"""FLOPs of the reference at a configuration's shapes, counted with
``torch.utils.flop_counter``'s formulas on the float32 reference, with
three formulas of the benchmark's own:

* a convolution's backward counts its input gradient and its weight gradient
  each as one forward convolution of the same shapes (a grouped convolution's
  weight gradient once, not once a group);
* ``grid_sample`` (the deformable attention's sampling) counts 2 operations
  a channel of each of 4 bilinear corners of every output point, and its
  backward twice that (the value's gradient and the grid's);
* everything else as ``FlopCounterMode`` counts it (matrix products,
  attention; elementwise work is not counted).

    python3 portbench/harness/flops.py --config sdetr_r50 [--canvas 800x1344 1344x800] [--write]

counts one image's serve forward on each canvas and one image's train step
(forward and backward with the configuration's contrastive-denoising slots)
on the landscape canvas (on the card where there is one: the full size is
too large for a shared CPU), and with ``--write`` stores them in the
configuration's file under ``flops``, so a run does not pay for the count.
Every shape of both paths is static (the denoising slots are a fixed
capacity), so the counts are per image for any batch."""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import conv_flop_count, flop_registry, shape_wrapper

aten = torch.ops.aten


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    one = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed=transposed)
    return int(one * (bool(output_mask[0]) + bool(output_mask[1])))


def grid_sample_flops(input_shape, grid_shape, *args, out_shape=None, **kwargs) -> int:
    N, C = input_shape[:2]
    points = math.prod(grid_shape[1:-1])
    return 2 * 4 * N * C * points


def grid_sample_backward_flops(grad_shape, input_shape, grid_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * grid_sample_flops(input_shape, grid_shape)


MAPPING = {
    aten.convolution_backward: conv_backward_flops,
    aten.grid_sampler_2d: grid_sample_flops,
    aten.grid_sampler_2d_backward: grid_sample_backward_flops,
}


class counter(TorchDispatchMode):
    """Counts the FLOPs of every operator dispatched while entered, by
    ``torch.utils.flop_counter``'s formulas and :data:`MAPPING`'s (the
    counting of ``FlopCounterMode`` without its module tracker, whose hooks
    refuse some of the reference's backward inputs)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.registry = {**flop_registry, **{k: shape_wrapper(v) for k, v in MAPPING.items()}}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out

    def get_total_flops(self) -> int:
        return self.total


def serve_flops(m, canvas, device="cpu", batch: int = 1) -> int:
    """FLOPs of the serve forward (detector and post-process) of ``batch``
    images filling ``canvas``."""
    from portbench.harness.weights import make_state_dict
    from portbench.reference import model as rm

    ref = rm.build(m, device)
    ref.load_state_dict(make_state_dict(rm.build(m, "meta"), 0, device))
    post = rm.postprocess(m)
    H, W = canvas
    images = torch.randn(batch, 3, H, W, device=device)
    sizes = torch.tensor([[H, W]] * batch, device=device)
    with torch.no_grad(), counter() as fc:
        out = ref(images, sizes)
        post(out["pred_class"][-1], out["pred_coord"][-1], sizes)
    return int(fc.get_total_flops())


def train_flops(m, canvas, device="cpu", batch: int = 1, gts: int = 7) -> int:
    """FLOPs of one train step's forward, losses and backward of ``batch``
    images filling ``canvas`` with ``gts`` gt boxes each."""
    from portbench.harness.weights import make_state_dict
    from portbench.reference import model as rm
    from portbench.reference.criterion import Targets, default_weight_dict
    from portbench.reference.denoising import cdn_draws
    from portbench.reference.detector import compute_loss

    ref = rm.build(m, device)
    ref.load_state_dict(make_state_dict(rm.build(m, "meta"), 0, device))
    ref.train()
    criterion, salience = rm.criteria(m)
    H, W = canvas
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn(batch, 3, H, W, generator=gen, device=device)
    sizes = torch.tensor([[H, W]] * batch, device=device)
    M = max(gts, 1)
    labels = torch.randint(0, m["num_classes"], (batch, M), generator=gen, device=device)
    boxes = torch.cat([torch.rand(batch, M, 2, generator=gen, device=device) * 0.5 + 0.25,
                       torch.rand(batch, M, 2, generator=gen, device=device) * 0.2 + 0.05], -1)
    valid = torch.ones(batch, M, dtype=torch.bool, device=device)
    targets = Targets(labels, boxes, valid, (gts,) * batch)
    draws = cdn_draws(batch, 2 * m["denoising_nums"], m["num_classes"], 0.5, gen, device)
    with counter() as fc:
        out = ref(images, sizes, targets, draws)
        losses = compute_loss(out, targets, sizes, criterion, salience, float(max(gts * batch, 1)),
                              default_weight_dict(m["num_decoder_layers"]), m["denoising_nums"])
        torch.stack([v.float() for v in losses.values()]).sum().backward()
    return int(fc.get_total_flops())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--canvas", nargs="*", default=["800x1344", "1344x800"])
    p.add_argument("--write", action="store_true")
    args = p.parse_args(argv)
    path = Path(__file__).resolve().parent.parent / "configs" / f"{args.config}.json"
    conf = json.loads(path.read_text())
    m = conf["model"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    flops = {"serve": {}, "train": {}}
    for c in args.canvas:
        canvas = tuple(int(x) for x in c.split("x"))
        flops["serve"][c] = serve_flops(m, canvas, device)
        print(f"serve {c}: {flops['serve'][c]:,} FLOPs an image", flush=True)
    c = args.canvas[0]
    flops["train"][c] = train_flops(m, tuple(int(x) for x in c.split("x")), device)
    print(f"train {c}: {flops['train'][c]:,} FLOPs an image-step", flush=True)
    if args.write:
        conf["flops"] = flops
        path.write_text(json.dumps(conf, indent=1) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))
    main()
