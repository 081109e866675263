"""Export the port's detector with ``torch.export`` (the twin of the JAX tool
``tools/export.py``, which writes StableHLO), check the saved program
against the live model, and run it standalone (:class:`ExportedDetector`).

    python -m salience_detr_torch.tools.export [--model-config F] [--checkpoint F]
        [--height 800] [--width 1344] [--batch 1] [--output exported_model.pt2]
        [--with-postprocess] [--no-verify] [--device cuda|cpu]

The eval forward (the last decoder layer's logits and boxes) is exported at
static shapes: the canvas, the batch and so the levels' shapes and token
budgets are Python ints of the trace.  ``--with-postprocess`` makes the
program (uint8 canvas pixels (B, 3, H, W), image_sizes (B, 2), orig_sizes
(B, 2)) -> {scores, labels, boxes, valid}: the dtype conversion, the
ImageNet normalization and ``PostProcess`` sit in the graph, only the resize
and padding onto the canvas stay on the host.  On CUDA the forward runs in
the config's dtype under autocast, as the eval step does (export captures
the autocast region); on the CPU in float32.

The kernels of every config are registered operators
(``torch.ops.salience_detr.ms_deform_attn``, ``grid_nms_topk`` and, with
PostProcess's NMS filter on, ``nms_keep_mask``; R50-DCN's
``deform_conv_fused`` and ``deform_conv_unfused``; the int8 encoder's
``q8_quantize`` and ``q8_sample``), so the graph calls them and a loaded
program launches the kernels on the card; ``import salience_detr_torch``
registers them, which is all a process needs before ``torch.export.load``.
As in the JAX tool, ``MSDA_GATHER_QUANT=int8`` is read at trace time: a
head-shared encoder then bakes the int8 sampling into the program, and the
saved file records which sampling it holds (:func:`load_program`; the
tool prints it).  ``--checkpoint`` takes the port's state dict (or a
training checkpoint's ``"model"``).  ``--verify`` (on by default) loads the
saved program and holds it against the live model on seeded inputs at rtol
1e-3 / atol 1e-5.  The tool runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from salience_detr_torch.models.detectors.salience_detr import normalize_images
from salience_detr_torch.parallel.train_step import eval_autocast
from salience_detr_torch.tools.common import add_model_args, load_model

RTOL, ATOL = 1e-3, 1e-5  # the reference's ONNX export check


class DetectorProgram(nn.Module):
    """What is exported: the eval forward, with ``with_postprocess`` from
    uint8 canvas pixels to detections."""

    def __init__(self, model: nn.Module, postprocess, cfg, with_postprocess: bool):
        super().__init__()
        self.model, self.postprocess, self.cfg = model, postprocess, cfg
        self.with_postprocess = with_postprocess

    def forward(self, images, image_sizes, orig_sizes=None):
        x = normalize_images(images.float() / 255.0) if self.with_postprocess else images
        with eval_autocast(x.device, self.cfg.dtype):
            out = self.model(x, image_sizes)
        if not self.with_postprocess:
            return out["pred_class"][-1], out["pred_coord"][-1]
        return self.postprocess(out["pred_class"][-1], out["pred_coord"][-1], orig_sizes)


def example_inputs(batch: int, height: int, width: int, with_postprocess: bool, device, seed: int = 0):
    """Seeded inputs of the program: uint8 pixels (or normal floats without
    postprocess) over the whole canvas."""
    gen = torch.Generator().manual_seed(seed)
    if with_postprocess:
        images = torch.randint(0, 256, (batch, 3, height, width), dtype=torch.uint8, generator=gen)
    else:
        images = torch.randn((batch, 3, height, width), generator=gen)
    sizes = torch.tensor([[height, width]] * batch, dtype=torch.int64)
    inputs = (images, sizes) + ((sizes.clone(),) if with_postprocess else ())
    return tuple(t.to(device) for t in inputs)


def export_detector(model: nn.Module, postprocess, cfg, batch: int, height: int, width: int,
                    with_postprocess: bool) -> torch.export.ExportedProgram:
    """``torch.export.export`` of :class:`DetectorProgram` at these static
    shapes on the model's device."""
    device = next(model.parameters()).device
    program = DetectorProgram(model.eval(), postprocess, cfg, with_postprocess).eval()
    with torch.no_grad():
        return torch.export.export(program, example_inputs(batch, height, width, with_postprocess, device),
                                   strict=False)


def call_targets(program: torch.export.ExportedProgram) -> List[str]:
    """Every operator the program's graphs call (the autocast region's
    subgraph included), by name."""
    return sorted({str(n.target) for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
                   for n in gm.graph.nodes if n.op == "call_function"})


def kernel_ops(program: torch.export.ExportedProgram) -> List[str]:
    """The port's kernel operators the program calls."""
    return [t for t in call_targets(program) if t.startswith("salience_detr.")]


SAMPLING_FILE = "encoder_sampling"  # the saved program's record of its encoder sampling


def encoder_sampling(program: torch.export.ExportedProgram) -> str:
    """The encoder sampling a traced program holds: "int8" where it calls
    the int8 operators (``MSDA_GATHER_QUANT=int8`` at trace time, a
    head-shared encoder), else "float"."""
    return "int8" if "salience_detr.q8_sample.default" in call_targets(program) else "float"


def save_program(program: torch.export.ExportedProgram, path) -> None:
    """``torch.export.save`` with the program's encoder sampling recorded
    beside it."""
    torch.export.save(program, str(path), extra_files={SAMPLING_FILE: encoder_sampling(program)})


def load_program(path) -> Tuple[torch.export.ExportedProgram, str]:
    """A saved program and the encoder sampling it holds ("float" for a
    file saved without the record)."""
    extra = {SAMPLING_FILE: ""}
    program = torch.export.load(str(path), extra_files=extra)
    return program, extra[SAMPLING_FILE] or "float"


def largest_gaps(got, want) -> Dict[str, float]:
    """Output by output (a dict's keys, or positions), the largest of
    |got - want| - rtol |want| over the elements: at most ATOL where the two
    agree at RTOL / ATOL."""
    if isinstance(want, dict):
        pairs = [(k, got[k], want[k]) for k in want]
    else:
        pairs = [(str(i), g, w) for i, (g, w) in enumerate(zip(got, want))]
    return {k: float(((g.detach().double() - w.double()).abs() - RTOL * w.double().abs()).max()) if w.numel()
            else 0.0 for k, g, w in pairs}


def verify(program: torch.export.ExportedProgram, live: nn.Module, inputs) -> Dict[str, float]:
    """The program against the live module on ``inputs``; raises beyond
    rtol 1e-3 / atol 1e-5."""
    with torch.no_grad():
        got = program.module()(*inputs)
        want = live(*inputs)
    gaps = largest_gaps(got, want)
    bad = {k: v for k, v in gaps.items() if not v <= ATOL}
    if bad:
        raise AssertionError(f"exported program differs from the live model beyond rtol {RTOL} / atol {ATOL}: {bad}")
    return gaps


class ExportedDetector:
    """A program saved with ``--with-postprocess``, run on whole images (the
    twin of the JAX tool's runner): the host eval geometry of the port's
    data pipeline (``shortest_size`` with the config's min and max size, then
    ``fit_to_canvas`` where the result exceeds the exported canvas, padded at
    the top left by ``pack_batch``), the program on the device it was
    exported on, and per image the detections that are ``valid`` and score
    above ``score_threshold``, in original-image coordinates.  ``import
    salience_detr_torch`` (done here) registers the kernels' operators the
    program calls; ``sampling`` is the encoder sampling the program holds."""

    def __init__(self, path_or_program: Union[str, os.PathLike, torch.export.ExportedProgram],
                 min_size: int = 800, max_size: int = 1333, score_threshold: float = 0.0):
        program = path_or_program
        if isinstance(program, torch.export.ExportedProgram):
            self.sampling = encoder_sampling(program)
        else:
            program, self.sampling = load_program(program)
        self.program = program
        names = set(program.graph_signature.user_inputs)
        specs = [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder" and n.name in names]
        if len(specs) != 3 or specs[0].dtype != torch.uint8:
            raise ValueError(f"the program takes {len(specs)} inputs, expected 3 (uint8 images, image_sizes, "
                             "orig_sizes): re-export with --with-postprocess")
        self.specs = specs
        self.batch, self.canvas = specs[0].shape[0], tuple(specs[0].shape[2:4])
        self.device = specs[0].device
        self.module = program.module()
        self.min_size, self.max_size = min_size, max_size
        self.score_threshold = score_threshold

    def inputs(self, images: Sequence[np.ndarray]):
        """(images, image_sizes, orig_sizes) of the program for uint8 HWC RGB
        images."""
        from salience_detr_torch.data.loader import fit_to_canvas, pack_batch
        from salience_detr_torch.data.transforms import shortest_size

        samples = []
        for img in images:
            img = np.asarray(img)
            s = {"image": img, "boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), np.int64),
                 "orig_size": img.shape[:2]}
            s = shortest_size(s, self.min_size, self.max_size)
            if s["image"].shape[0] > self.canvas[0] or s["image"].shape[1] > self.canvas[1]:
                s = fit_to_canvas(s, self.canvas)
            samples.append(s)
        batch = pack_batch(samples, self.canvas, max_gt=1)
        images = torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous()
        arrays = (images, torch.from_numpy(batch["image_sizes"]), torch.from_numpy(batch["orig_sizes"]))
        return tuple(a.to(device=self.device, dtype=spec.dtype) for a, spec in zip(arrays, self.specs))

    def detect(self, images: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
        """The program's whole output for exactly ``batch`` images, as numpy."""
        if len(images) != self.batch:
            raise ValueError(f"the program was exported for batch {self.batch}, got {len(images)} images")
        with torch.no_grad():
            dets = self.module(*self.inputs(images))
        return {k: v.cpu().numpy() for k, v in dets.items()}

    def __call__(self, images):
        """One uint8 HWC RGB image (-> one dict) or a list of ``batch``
        images (-> a list): boxes (xyxy), scores and labels kept."""
        single = not isinstance(images, (list, tuple))
        dets = self.detect([images] if single else list(images))
        out = []
        for i in range(self.batch):
            keep = dets["valid"][i].astype(bool) & (dets["scores"][i] > self.score_threshold)
            out.append({k: dets[k][i][keep] for k in ("boxes", "scores", "labels")})
        return out[0] if single else out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--output", default="exported_model.pt2")
    p.add_argument("--verify", action=argparse.BooleanOptionalAction, default=True,
                   help="hold the saved program against the live model (rtol 1e-3, atol 1e-5)")
    p.add_argument("--with-postprocess", action="store_true",
                   help="export (uint8 canvas, image_sizes, orig_sizes) -> detections in original-image "
                        "coordinates, runnable by ExportedDetector")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    predictor = load_model(args)
    cfg, model, postprocess = predictor.cfg, predictor.model, predictor.postprocess
    if args.checkpoint:
        print(f"restored checkpoint from {args.checkpoint}")
    t0 = time.perf_counter()
    program = export_detector(model, postprocess, cfg, args.batch, args.height, args.width, args.with_postprocess)
    seconds = time.perf_counter() - t0
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    save_program(program, args.output)
    print(f"exported {os.path.getsize(args.output) / 2**20:.1f} MiB program to {args.output} in {seconds:.1f} s; "
          f"kernel operators {kernel_ops(program)}; encoder sampling {encoder_sampling(program)} "
          f"(MSDA_GATHER_QUANT={os.environ.get('MSDA_GATHER_QUANT', 'none')} at trace time)")
    if args.verify:
        live = DetectorProgram(model, postprocess, cfg, args.with_postprocess).eval()
        device = next(model.parameters()).device
        inputs = example_inputs(args.batch, args.height, args.width, args.with_postprocess, device, seed=1)
        verify(load_program(args.output)[0], live, inputs)
        print(f"verification passed (rtol={RTOL:g}, atol={ATOL:g})")


if __name__ == "__main__":
    main()
