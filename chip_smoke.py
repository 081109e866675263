#!/usr/bin/env python3
"""Drive the PyTorch port (salience_detr_torch) on one CUDA card.

    python3 chip_smoke.py [--baseline-csrc DIR [DIR ...]]

Phases, each printing one line of facts; any failure ends the script with a
non-zero exit and no result line:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: compiles salience_detr_torch/csrc/*.cu (nvcc, sm_90a);
3. msda: the MSDA kernel against its plain PyTorch version at the flagship's
   shapes (S=22323 over four levels; G=1 at Q=11403 and G=8 at Q=900, B=4),
   in float32 with TF32 off and in bfloat16, with times;
4. grid_nms: the grid-NMS kernel against its plain version at K=3600, B=4,
   exactly equal, on random candidates, on the same with a raster clump in
   one image, and on a snake path (one chain of 3600), with times;
5. slice: a small random-weight model in float32 on the card (kernels)
   against the same model on the CPU (plain versions, which the CPU tests
   hold against the JAX package): same proposals, outputs within tolerance;
6. serve: the flagship R50 model (random weights from a seed, bf16) answers
   3 batches of 4 requests of mixed sizes and orientations through
   ``Predictor``; the launch counters must show 12 MSDA launches and 1 NMS
   launch per forward; a repeated batch must give identical detections; then
   the median of 3 timed B=4 forwards at the 800x1344 canvas;
7. msda_backward: the MSDA backward kernel against the plain backward and
   against autograd of the plain forward, at the train step's shapes (G=1 at
   Q=11403 and G=8 at Q=1100: 900 queries and 200 CDN slots, B=4), in
   float32 with TF32 off and in bfloat16, with times;
8. hungarian: the assignment kernel against the plain assignment at B=4,
   N=900, M=100 on matching costs of random boxes and logits, exactly equal,
   each image's total cost equal to scipy's optimum, with times;
9. train_slice: one train step of a small random-weight model in float32 on
   the card (kernels) and on the CPU (plain versions, which the CPU tests hold
   against the JAX package), from the same init, batch and CDN draws: same
   assignments (the 3 sets of one batched matching call on each side),
   losses, gradients and updated parameters within tolerance;
10. train: the flagship R50 trains through the entry point's ``Trainer``
   (python -m salience_detr_torch.train) at B=4 on the 800x1344 canvas, bf16
   autocast, gts padded to 100 with 24, 7, 40 and 1 valid: one warm-up step
   through ``train_one_epoch``, then 3 timed steps whose launch counters must
   show 12 MSDA forward, 12 MSDA backward, 1 NMS and 1 assignment launch
   each (the criterion matches its 7 sets in one launch); losses finite,
   trainable parameters moved, frozen ones not;
11. msda_captured: the inputs the main path gives the MSDA kernels, captured
   from one flagship train step at init (value, locations, weights and d_out
   of the first encoder layer, G=1 Q=11403, and the first decoder layer, G=8
   Q=1100): the MSDA forward and backward kernels against their plain
   versions (and the backward against autograd of the plain forward) at the
   tolerances of phases 3 and 7, with times, bounds and the corners'
   statistics (in-level and nonzero-weight shares, adds per row).  With
   ``--baseline-csrc``, each directory's MSDA kernels (another version of
   csrc/, for example the parent commit's) are built and timed in turns with
   these (base, new, new, base) on the captured inputs and on uniform ones;
12. nms_assignment_captured: the inputs the main path gives K2 and K4: the
   candidates of a flagship serve forward (B=4, the TIMED_BATCH canvas) and
   the stacked (7 x 4, 900, 100) costs of the train step of phase 11, held
   exactly against the plain versions (K4's totals also against scipy), with
   facts computed on the host: candidates per level and fixpoint rounds per
   (image, level) for K2 (also for phase 4's orders), Dijkstra steps per
   (set, image) for K4; times and bounds.  With ``--baseline-csrc``, each
   directory's grid-NMS and assignment kernels are timed in turns with these
   (``nms_ab:``, ``assign_ab:``): K2 on the captured and phase 4's orders,
   K4 on the captured costs as the baseline's one launch per set of 4
   images against the shipped single launch, then both as single launches,
   and on phase 8's costs;
13. msda_stages: the staged MSDA shootout's entry point
   (python -m salience_detr_torch.tools.msda_stages --q 11403 --iters 3:
   every pipeline checked against the plain MSDA at Q=256, then timed beside
   K1, the kernel-only timings and the row-width scan); its launch counters
   must show each stage kernel K5-K8 launched.  Then, at the hot layer (B=4,
   Q=11403, bf16 rows), each stage kernel against its plain version with
   times, bound and one library call of the same function (K6 with f32 and
   bf16 weights, K7 and K8 with f32 and bf16 outputs, K8 with bf16 weights),
   and each of the seven pipelines against K1 within the shootout's check
   bound (rtol 0.05, atol 0.02).  The serve and train phases' counters show
   no stage-kernel launch.

The line before the last is {"kernels": [...]}: per kernel its launches in
the counted train steps (3; K4 launches once a step), its largest error, its time, its plain version's
time, its bound (``bound_ms``: bytes over 3.35 TB/s or f32 operations over
67 TFLOP/s, whichever is larger, ``bound_by`` which) and the time of one
PyTorch call of the same function (``library_ms``, null where there is
none).  The last line is {"ok": true, "device": {...}}.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from salience_detr_torch import native
from salience_detr_torch.engine.train import train_one_epoch
from salience_detr_torch.inference import DEFAULT_CONFIG, Predictor, load_config, preprocess
from salience_detr_torch.models.bricks import attention, salience_transformer
from salience_detr_torch.models.bricks import criterion as criterion_module
from salience_detr_torch.models.bricks.attention import MultiScaleDeformableAttention
from salience_detr_torch.models.bricks.criterion import Targets, compute_matching_cost
from salience_detr_torch.models.bricks.denoising import cdn_draws
from salience_detr_torch.models.factory import SalienceDETRConfig
from salience_detr_torch.ops import msda_stages as stages
from salience_detr_torch.ops.deform_attn import (
    _backward_cuda,
    ms_deform_attn,
    ms_deform_attn_backward_plain,
    ms_deform_attn_plain,
)
from salience_detr_torch.ops.hungarian import batched_assignment, batched_assignment_plain
from salience_detr_torch.ops.nms import grid_nms_topk, grid_nms_topk_plain
from salience_detr_torch.timing import card_line, cuda_ms
from salience_detr_torch.tools import msda_stages as stage_tool
from salience_detr_torch.train import GT_COUNTS, Trainer, load_train_config

LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21)]  # 800x1344 canvas, strides 8..64
# (atol, rtol).  bf16: both sides round one f32 sum, so they differ by at most
# one bf16 ulp (2**-7 relative); accumulating or rounding in bf16 errs more.
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (4e-3, 1e-2)}
SERVE_BATCHES = [
    [(480, 640), (800, 1200), (1024, 768), (600, 600)],
    [(720, 1280), (1333, 800), (375, 500), (640, 427)],
    [(1080, 1920), (300, 400), (768, 1024), (900, 600)],
]
TIMED_BATCH = [(480, 640), (800, 1200), (600, 600), (720, 1280)]  # one landscape canvas
# MSDA backward, (atol as a share of the output's largest magnitude, rtol),
# by the gradient's dtype.  float32: the kernel adds d_value with atomics
# and sums d_locations and d_weights across lanes, in other orders than the
# plain version.  bfloat16 (d_value of a bf16 value, d_weights of bf16
# weights): one f32 sum rounded once to bf16 on both sides (one ulp, 2**-7
# relative).
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
HUNGARIAN_COUNTS = [(24, 7, 40, 1), (100, 0, 57, 100)]
NMS_K, NMS_OUT = 3600, 900  # the flagship's top-4N candidates and N proposals
# the least time of a kernel's work on an H100 SXM at its 700 W limit: its
# bytes (each input read once, each output written once) over 3.35 TB/s of
# HBM, or its f32 operations over 67 TFLOP/s outside the tensor cores,
# whichever is larger
HBM_BYTES_PER_MS = 3.35e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3
STAGE_KERNELS = ("gather_sum", "weighted_reduce", "corner_collapse_blocked", "corner_collapse_packed")
NO_STAGE_LAUNCHES = {k: 0 for k in STAGE_KERNELS}
SMALL = dict(
    backbone="resnet18", embed_dim=32, num_classes=5, num_queries=24,
    num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=64,
    topk_sa=12, layer_filter_ratio=(1.0, 0.5), max_num_embedding=16,
    encoder_sampling_groups=1, min_size=96, max_size=128, select_box_nums_for_evaluation=20,
)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = card_line()
    print(smi)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"name={torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    path = native.build()
    native.load()
    print(f"build: {path} in {time.perf_counter() - t0:.2f} s")


def compare(got, want, dtype):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    bad = int((err > bound).sum())
    max_rel = float((err / want.float().abs().clamp_min(1e-6)).max())
    return float(err.max()), max_rel, bad, atol, rtol


def bound(moved_bytes, ops):
    """(bound_ms, bound_by) of work that moves ``moved_bytes`` and does
    ``ops`` f32 operations."""
    by_bytes, by_ops = moved_bytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def corner_counts(locs, levels):
    """Over all (b, q, g, l, p) of ``locs`` (B, Q, G, L, P, 2): the in-level
    corners, those of them with a nonzero bilinear weight, and per level the
    nonzero-weight corners that land on each touched (image, row): (mean,
    max).  ``loc * w - 0.5`` is rounded twice, as the kernels compute it."""
    in_level, nonzero, per_level = 0, 0, []
    image = torch.arange(locs.shape[0], device=locs.device).view(-1, 1, 1, 1)
    for lvl, (h, w) in enumerate(levels):
        x = locs[:, :, :, lvl, :, 0].float() * w - 0.5
        y = locs[:, :, :, lvl, :, 1].float() * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        rows = []
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                cx, cy = x0.long() + dx, y0.long() + dy
                ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
                hit = ok & (wx * wy != 0)
                in_level += int(ok.sum())
                nonzero += int(hit.sum())
                rows.append(((image * h + cy) * w + cx)[hit])
        adds = torch.bincount(torch.cat(rows), minlength=locs.shape[0] * h * w)
        adds = adds[adds > 0].float()
        per_level.append((float(adds.mean()), int(adds.max())) if adds.numel() else (0.0, 0))
    return in_level, nonzero, per_level


def msda_bounds(value, locs, weights):
    """Bounds of K1 and K3 on these inputs.  K1 reads value, locations and
    weights (f32, as the kernel takes them) and writes (B, Q, C) in the value
    dtype; 2 operations per channel of each nonzero-weight corner.  K3 also
    reads d_out and writes d_value (f32), d_locations and d_weights (f32);
    2 operations per channel for each in-level corner's dot product and 2 for
    each nonzero-weight corner's scatter."""
    B, S, C = value.shape
    Q, G = locs.shape[1:3]
    in_level, nonzero, _ = corner_counts(locs, LEVELS)
    small = 4 * (locs.numel() + weights.numel())
    out = B * Q * C * value.element_size()
    forward = bound(nbytes(value) + small + out, 2 * nonzero * (C // G))
    backward = bound(nbytes(value) + out + 2 * small + B * S * C * 4,
                     2 * (in_level + nonzero) * (C // G))
    return forward, backward


def uniform_msda_inputs(gen, G, Q, B=4, H=8, C=256, P=4):
    """value (B, S, C) f32 normal, locations uniform in [-0.2, 1.2] (about half
    the points partly outside their level), weights normalised over (L, P)."""
    S, L = sum(h * w for h, w in LEVELS), len(LEVELS)
    dev = torch.device("cuda")
    value32 = torch.randn(B, S, C, generator=gen, device=dev)
    locs = torch.rand(B, Q, G, L, P, 2, generator=gen, device=dev) * 1.4 - 0.2
    weights = torch.rand(B, Q, H, L, P, generator=gen, device=dev)
    return value32, locs, weights / weights.sum((-2, -1), keepdim=True)


def phase_msda():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S = sum(h * w for h, w in LEVELS)
    B, H, C, P = 4, 8, 256, 4
    worst, timing = 0.0, None
    for G, Q in ((1, 11403), (8, 900)):
        value32, locs, weights = uniform_msda_inputs(gen, G, Q, B, H, C, P)
        for dtype in (torch.float32, torch.bfloat16):
            value = value32.to(dtype)
            got = ms_deform_attn(value, LEVELS, locs, weights)
            want = ms_deform_attn_plain(value, LEVELS, locs, weights)
            torch.cuda.synchronize()
            max_abs, max_rel, bad, atol, rtol = compare(got, want, dtype)
            ms = cuda_ms(lambda: ms_deform_attn(value, LEVELS, locs, weights), 20)
            plain_ms = cuda_ms(lambda: ms_deform_attn_plain(value, LEVELS, locs, weights), 5)
            print(f"msda: G={G} B={B} Q={Q} S={S} C={C} {str(dtype)[6:]} max_abs_err={max_abs:.3e} "
                  f"max_rel_err={max_rel:.3e} atol={atol} rtol={rtol} violations={bad} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if bad:
                raise AssertionError(f"msda kernel disagrees with plain at G={G} {dtype}: {bad} elements")
            worst = max(worst, max_abs)
            if G == 1 and dtype == torch.bfloat16:  # the encoder's hot shape on the main path
                timing = (ms, plain_ms, *msda_bounds(value, locs, weights)[0])
    return worst, timing


def snake_path(h, w, device=None):
    """The tokens of an h x w level on a path through rows 0, 2, 4, ... in
    turn left to right and right to left, each joined to the next by the one
    cell of the row between them: no two cells of the path touch but
    neighbours on it, so greedy NMS in path order is one chain."""
    grid = torch.arange(h * w, device=device).view(h, w)
    parts = []
    for k, r in enumerate(range(0, h, 2)):
        parts.append(grid[r] if k % 2 == 0 else grid[r].flip(0))
        if r + 2 < h:
            parts.append(grid[r + 1, -1:] if k % 2 == 0 else grid[r + 1, :1])
    return torch.cat(parts)


def nms_orders(dev, K=NMS_K):
    """Candidate orders over LEVELS, (4, K) int32 each: "random" draws;
    "raster clump", the same draws with image 1 on tokens 0..K-1 in raster
    order (chains about 190 rounds deep on level 0); "snake", every image on
    the first K tokens of ``snake_path`` on level 0 (one chain of K)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    S = sum(h * w for h, w in LEVELS)
    rand = torch.stack([torch.randperm(S, generator=gen, device=dev)[:K] for _ in range(4)])
    clump = rand.clone()
    clump[1] = torch.arange(K, device=dev)
    snake = snake_path(*LEVELS[0], device=dev)[:K].expand(4, K)
    return {name: t.to(torch.int32).contiguous()
            for name, t in (("random", rand), ("raster clump", clump), ("snake", snake))}


def phase_grid_nms():
    S, num_out = sum(h * w for h, w in LEVELS), NMS_OUT
    for name, topk in nms_orders(torch.device("cuda")).items():
        got = grid_nms_topk(topk, LEVELS, num_out)
        want = grid_nms_topk_plain(topk, LEVELS, num_out)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        ms = cuda_ms(lambda: grid_nms_topk(topk, LEVELS, num_out), 20)
        print(f"grid_nms: {name} B=4 K={topk.shape[1]} S={S} num_out={num_out} mismatches={mismatches} "
              f"kernel_ms={ms:.4f}")
        if mismatches:
            raise AssertionError(f"grid_nms kernel differs from plain in {mismatches} entries on {name}")


def phase_slice():
    """Small random-weight model, float32: card (kernels) vs CPU (plain)."""
    cfg = SalienceDETRConfig(**SMALL)
    cpu = Predictor(cfg, None, "cpu", seed=3)
    gpu = Predictor(cfg, None, "cuda", seed=3)
    rng = np.random.default_rng(3)
    requests = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in ((70, 101), (96, 128))]
    images, sizes, _ = preprocess(requests, cfg, "cpu")
    with torch.no_grad():
        want = cpu.model(images, sizes)
        got = gpu.model(images.cuda(), sizes.cuda())
    torch.cuda.synchronize()
    same_proposals = torch.equal(got["proposal_index"].cpu(), want["proposal_index"])
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in ("pred_class", "pred_coord")}
    ok = same_proposals and all(
        torch.allclose(got[k].cpu(), want[k], rtol=1e-3, atol=1e-3) for k in errs
    )
    print(f"slice: tiny float32 card-vs-cpu same_proposals={same_proposals} "
          f"max_abs_err={errs} rtol=1e-3 atol=1e-3")
    if not ok:
        raise AssertionError("small-model forward on the card disagrees with the CPU forward")


def make_requests(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


def phase_serve(smi):
    cfg = load_config(DEFAULT_CONFIG)  # the flagship
    predictor = Predictor(cfg, None, "cuda", seed=0)
    batches = [make_requests(sizes, seed) for seed, sizes in enumerate(SERVE_BATCHES)]
    t0 = time.perf_counter()
    predictor(batches[0])  # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    forwards = sum(len(predictor.groups(b)) for b in batches)
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
    results = [predictor(b) for b in batches]
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    layers = cfg.num_encoder_layers + cfg.num_decoder_layers
    if launches != {"msda": layers * forwards, "grid_nms": forwards, "msda_backward": 0, "hungarian": 0,
                    **NO_STAGE_LAUNCHES}:
        raise AssertionError(f"launch counts {launches} for {forwards} forwards")
    k = cfg.select_box_nums_for_evaluation
    for sizes, batch in zip(SERVE_BATCHES, results):
        for (h, w), r in zip(sizes, batch):
            assert r["scores"].shape == (k,) and r["labels"].shape == (k,), r["scores"].shape
            assert r["boxes"].shape == (k, 4)
            assert all(bool(v.isfinite().all()) for v in (r["scores"], r["boxes"].float()))
            assert int(r["labels"].min()) >= 0 and int(r["labels"].max()) < cfg.num_classes
    again = predictor(batches[0])
    identical = all(
        torch.equal(a[key], b[key]) for a, b in zip(results[0], again) for key in a
    )
    if not identical:
        raise AssertionError("two runs on the same batch gave different detections")

    timed = make_requests(TIMED_BATCH, 7)
    inputs = preprocess(timed, cfg, "cuda")
    predictor.forward(*inputs)  # first forward at this canvas and batch size
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        predictor.forward(*inputs)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    canvas = tuple(inputs[0].shape[-2:])
    print(f"serve: flagship R50 bf16, {len(batches)} batches of 4 requests in {forwards} forwards; "
          f"launches={launches}; identical_rerun={identical}; warmup_s={warmup_s:.2f}; "
          f"B=4 canvas={canvas[0]}x{canvas[1]} forward_ms={[round(x, 3) for x in times]} "
          f"median_ms={med:.3f} img_s={4000.0 / med:.3f}; card: {smi}")
    return launches


def compare_bwd(got, want):
    atol_rel, rtol = BWD_TOL[want.dtype]
    ref = want.float()
    err = (got.float() - ref).abs()
    scale = float(ref.abs().max())
    bad = int((err > atol_rel * scale + rtol * ref.abs()).sum())
    return float(err.max()), scale, bad, atol_rel, rtol


def backward_checks(value, locs, weights, d_out, label):
    """K3 through autograd (counted) against the plain backward and against
    autograd of the plain forward.  Returns the largest error and the
    report's parts; raises on a violation."""
    inputs = [x.clone().requires_grad_() for x in (value, locs, weights)]
    before = native.LAUNCHES["msda_backward"]
    ms_deform_attn(inputs[0], LEVELS, inputs[1], inputs[2]).backward(d_out)
    torch.cuda.synchronize()
    if native.LAUNCHES["msda_backward"] != before + 1:
        raise AssertionError("the MSDA backward kernel did not run")
    got = [x.grad for x in inputs]
    plain = ms_deform_attn_backward_plain(value, LEVELS, locs, weights, d_out)
    auto = [x.clone().requires_grad_() for x in (value, locs, weights)]
    ms_deform_attn_plain(auto[0], LEVELS, auto[1], auto[2]).backward(d_out)
    torch.cuda.synchronize()
    worst, parts = 0.0, []
    for ref_name, refs in (("plain", plain), ("autograd", [x.grad for x in auto])):
        for name, g, r in zip(("d_value", "d_locations", "d_weights"), got, refs):
            max_abs, scale, bad, atol_rel, rtol = compare_bwd(g, r)
            parts.append(f"{name}_vs_{ref_name}={max_abs:.3e}(max|ref| {scale:.3e}, "
                         f"atol {atol_rel}*max, rtol {rtol}, violations {bad})")
            if bad:
                raise AssertionError(f"msda backward {name} disagrees with {ref_name} at {label}: "
                                     f"{bad} elements")
            worst = max(worst, max_abs)
    return worst, parts


def phase_msda_backward():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    S = sum(h * w for h, w in LEVELS)
    B, H, C, P = 4, 8, 256, 4
    worst, timing = 0.0, None
    for G, Q in ((1, 11403), (8, 1100)):
        value32, locs, weights = uniform_msda_inputs(gen, G, Q, B, H, C, P)
        d_out32 = torch.randn(B, Q, C, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            value, d_out = value32.to(dtype), d_out32.to(dtype)
            err, parts = backward_checks(value, locs, weights, d_out, f"G={G} {dtype}")
            worst = max(worst, err)
            # the kernel's wrapper alone: scratch zeroing, launch, bf16 cast
            ms = cuda_ms(lambda: _backward_cuda(value, LEVELS, locs, weights, d_out), 10)
            plain_ms = cuda_ms(
                lambda: ms_deform_attn_backward_plain(value, LEVELS, locs, weights, d_out), 3
            )
            print(f"msda_backward: G={G} B={B} Q={Q} S={S} C={C} {str(dtype)[6:]} "
                  f"{' '.join(parts)} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if G == 1 and dtype == torch.bfloat16:  # the encoder's hot shape on the main path
                timing = (ms, plain_ms, *msda_bounds(value, locs, weights)[1])
    return worst, timing


def hungarian_costs(dev):
    """(counts, cost (4, 900, 100), valid) for each of HUNGARIAN_COUNTS: the
    matching costs of random boxes and logits."""
    rng = np.random.default_rng(5)
    B, N, M, K = 4, 900, 100, 91
    sets = []
    for counts in HUNGARIAN_COUNTS:
        logits = torch.from_numpy(rng.normal(size=(B, N, K)).astype(np.float32) * 2).to(dev)
        cxy = rng.uniform(0.1, 0.9, (B, N, 2))
        wh = rng.uniform(0.02, 0.4, (B, N, 2))
        pred = torch.from_numpy(np.concatenate([cxy, wh], -1).astype(np.float32)).to(dev)
        gt = np.zeros((B, M, 4), np.float32)
        gt[..., :2] = rng.uniform(0.25, 0.7, (B, M, 2))
        gt[..., 2:] = rng.uniform(0.05, 0.25, (B, M, 2))
        valid = np.arange(M)[None] < np.asarray(counts)[:, None]
        targets = Targets(torch.from_numpy(rng.integers(0, K, (B, M))).to(dev),
                          torch.from_numpy(gt).to(dev), torch.from_numpy(valid).to(dev), counts)
        sets.append((counts, compute_matching_cost(logits, pred, targets), targets.valid))
    return sets


def scipy_gaps(cost, got, valid):
    """Per image: checks that ``got`` matches every valid gt to a distinct
    query, and returns |its total cost - scipy's optimum|."""
    from scipy.optimize import linear_sum_assignment

    host_cost, host_got, host_valid = cost.float().cpu().numpy(), got.cpu().numpy(), valid.cpu().numpy()
    gaps = []
    for b in range(host_cost.shape[0]):
        cols = np.flatnonzero(host_valid[b])
        r, c = linear_sum_assignment(host_cost[b][:, cols])
        ours = float(sum(host_cost[b][host_got[b][j], j] for j in cols))
        if len(set(host_got[b][cols].tolist())) != len(cols) or np.any(host_got[b][~host_valid[b]] != -1):
            raise AssertionError(f"image {b}: not a matching of the valid gts")
        gaps.append(abs(ours - float(host_cost[b][r, c].sum())))
    return gaps


def phase_hungarian():
    for counts, cost, valid in hungarian_costs(torch.device("cuda")):
        B, N, M = cost.shape
        got = batched_assignment(cost, valid)
        want = batched_assignment_plain(cost, valid)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        gaps = scipy_gaps(cost, got, valid)
        ms = cuda_ms(lambda: batched_assignment(cost, valid), 10)
        plain_ms = cuda_ms(lambda: batched_assignment_plain(cost, valid), 2)
        print(f"hungarian: B={B} N={N} M={M} valid={counts} mismatches={mismatches} "
              f"total_cost_gap_vs_scipy={max(gaps):.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if mismatches or max(gaps) > 1e-3:
            raise AssertionError(f"assignment kernel differs: {mismatches} entries, cost gap {max(gaps)}")


def small_train_step(device, counts=(3, 1)):
    """One train step of the small model on ``device`` from seed 6; returns
    (metrics, assignments, clipped gradients, parameters, buffers, calls of
    the criterion's batched matching)."""
    cfg = SalienceDETRConfig(**SMALL, denoising_nums=4)
    tc = dict(load_train_config(), max_gt=6, train_canvas=(96, 128))
    trainer = Trainer(cfg, device, seed=6, steps_per_epoch=1, train_cfg=tc)
    # At init the sampling-offset weights are zero, so most sampling points
    # sit exactly on pixel centres, where the bilinear weights have a kink:
    # there the gradient is a one-sided derivative that a last-bit difference
    # upstream (the card's GEMMs) may pick from the other side.  Small random
    # weights, the same on both devices, move the points off the kinks.
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in trainer.model.modules():
            if isinstance(m, MultiScaleDeformableAttention):
                w = m.sampling_offsets.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.02)
    batch = next(trainer.batches(1, seed=6, counts=counts))
    batch["image_sizes"][1] = torch.tensor([70, 101])  # one padded image
    draws = cdn_draws(len(counts), 8, cfg.num_classes, 0.5, torch.Generator().manual_seed(6), "cpu")
    draws = type(draws)(*(x.to(device) for x in draws))
    matches, calls, match_sets = [], [], trainer.criterion.match_sets

    def recording_match_sets(*args):
        calls.append(match_sets(*args))
        matches.extend(calls[-1])
        return calls[-1]

    trainer.criterion.match_sets = recording_match_sets
    metrics = trainer.step(batch, draws=draws)
    model = trainer.model
    return (
        {k: float(v) for k, v in metrics.items()},
        [m.cpu() for m in matches],
        {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None},
        {n: p.detach().cpu() for n, p in model.named_parameters()},
        {n: b.cpu() for n, b in model.named_buffers()},
        len(calls),
    )


def phase_train_slice():
    """Small random-weight model, float32: a train step on the card (kernels)
    vs the same step on the CPU (plain versions)."""
    gpu = small_train_step("cuda")
    cpu = small_train_step("cpu")
    same_matches = len(gpu[1]) == len(cpu[1]) and all(torch.equal(a, b) for a, b in zip(gpu[1], cpu[1]))
    loss_err = max(abs(gpu[0][k] - v) / max(abs(v), 1e-12) for k, v in cpu[0].items())
    # gradients before the clip (the step clips in place to norm 0.1): per
    # tensor, max |d| <= 1e-3 max |g| + 1e-6, for atomics and summation order
    def unclipped(run):
        return {n: g / (0.1 / max(run[0]["grad_norm"], 0.1)) for n, g in run[2].items()}

    g_gpu, g_cpu = unclipped(gpu), unclipped(cpu)
    grad_ratio, worst_grad = max(
        (float((g_gpu[n] - g).abs().max()) / (1e-3 * float(g.abs().max()) + 1e-6), n)
        for n, g in g_cpu.items()
    )
    param_err = max(float((gpu[3][n] - p).abs().max()) for n, p in cpu[3].items())
    buffer_err = max(float((gpu[4][n].float() - b.float()).abs().max()) for n, b in cpu[4].items())
    print(f"train_slice: small float32 train step card-vs-cpu assignments={len(gpu[1])} "
          f"in {gpu[5]} batched matching call(s) "
          f"same_assignments={same_matches} max_loss_rel_err={loss_err:.3e} (rtol 1e-4) "
          f"grad_err/bound={grad_ratio:.3e} at {worst_grad} (bound 1e-3*max|g|+1e-6) "
          f"param_max_abs_err={param_err:.3e} (atol 1e-6) buffer_max_abs_err={buffer_err:.3e} (atol 1e-5) "
          f"same_grad_set={set(gpu[2]) == set(cpu[2])}")
    if not (same_matches and len(gpu[1]) == 3 and gpu[5] == cpu[5] == 1 and loss_err <= 1e-4 and grad_ratio <= 1.0
            and param_err <= 1e-6 and buffer_err <= 1e-5 and set(gpu[2]) == set(cpu[2])):
        raise AssertionError("the small train step on the card disagrees with the CPU step")


def phase_train(smi):
    cfg = load_config(DEFAULT_CONFIG)  # the flagship
    # the criterion matches all 7 sets (6 decoder layers, the encoder) in one launch
    per_step = {"msda": 12, "msda_backward": 12, "grid_nms": 1, "hungarian": 1, **NO_STAGE_LAUNCHES}
    timed = 3
    trainer = Trainer(cfg, "cuda", seed=0, steps_per_epoch=1 + timed)
    batches = list(trainer.batches(1 + timed, seed=0, counts=GT_COUNTS))
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    t0 = time.perf_counter()
    train_one_epoch(trainer.step, batches[:1], trainer.generator, 0, trainer.print_freq)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
    times, metrics = [], None
    for batch in batches[1:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = trainer.step(batch, trainer.generator)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = dict(native.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != {k: v * timed for k, v in per_step.items()}:
        raise AssertionError(f"launch counts {launches} for {timed} train steps")
    host = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in host.values()):
        raise AssertionError(f"non-finite train metrics: {host}")
    moved, still, nonzero = 0, 0, 0
    for n, p in trainer.model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if not p.requires_grad:
            if not same:
                raise AssertionError(f"frozen parameter {n} changed")
            still += 1
            continue
        # a gradient at rounding level (the softmax-invariant conv_mask
        # biases of the neck's context blocks) moves nothing
        if float(p.grad.abs().max()) > 1e-6:
            nonzero += 1
            if same:
                raise AssertionError(f"trainable parameter {n} with a gradient did not change")
        moved += not same
    trainable = sum(p.requires_grad for p in trainer.model.parameters())
    top_grad = max((float(p.grad.norm()), n) for n, p in trainer.model.named_parameters()
                   if p.grad is not None)[1]
    med = statistics.median(times)
    print(f"train: flagship R50 bf16 B=4 canvas={tuple(batches[0]['images'].shape[-2:])} "
          f"gts={GT_COUNTS} max_gt={trainer.max_gt}; warmup_s={warmup_s:.2f}; "
          f"launches over {timed} steps={launches}; loss={host['loss']:.4f} "
          f"grad_norm={host['grad_norm']:.4f} (largest in {top_grad}) all {len(host)} metrics finite; "
          f"trainable moved {moved}/{trainable} (all {nonzero} with a clipped gradient above 1e-6), "
          f"frozen unchanged {still}; step_ms={[round(x, 3) for x in times]} median_ms={med:.3f} "
          f"img_s={4000.0 / med:.3f} peak_mem_gib={peak_gib:.3f}; card: {smi}")
    return launches


def capture_train_inputs():
    """What one flagship train step at init, as the train phase builds it
    (``Trainer``, B=4, 800x1344, bf16 autocast), gives its kernels: value,
    locations, weights and d_out of the first encoder layer (G=1, Q=11403)
    and the first decoder layer (G=8, Q=1100), recorded by a wrapper around
    the MSDA modules' call of ``ms_deform_attn``; and the stacked (7 * B,
    900, 100) costs and valid mask that the criterion hands to
    ``batched_assignment``."""
    cfg = load_config(DEFAULT_CONFIG)
    trainer = Trainer(cfg, "cuda", seed=0, steps_per_epoch=1)
    batch = next(trainer.batches(1, seed=0, counts=GT_COUNTS))
    calls, real = [], attention.ms_deform_attn
    assignments, real_assignment = [], criterion_module.batched_assignment

    def recording_assignment(cost, valid):
        assignments.append((cost.detach().clone(), valid.clone()))
        return real_assignment(cost, valid)

    def recording(value, spatial_shapes, locations, weights):
        out = real(value, spatial_shapes, locations, weights)
        call = {"value": value.detach(), "locations": locations.detach(),
                "weights": weights.detach(), "levels": [tuple(x) for x in spatial_shapes]}
        out.register_hook(lambda grad: call.__setitem__("d_out", grad.detach()))
        calls.append(call)
        return out

    attention.ms_deform_attn = recording
    criterion_module.batched_assignment = recording_assignment
    try:
        trainer.step(batch, trainer.generator)
    finally:
        attention.ms_deform_attn = real
        criterion_module.batched_assignment = real_assignment
    torch.cuda.synchronize()
    if len(calls) != cfg.num_encoder_layers + cfg.num_decoder_layers:
        raise AssertionError(f"{len(calls)} MSDA calls in one train step")
    captured = {"encoder": calls[0], "decoder": calls[cfg.num_encoder_layers]}
    for name, c in captured.items():
        if c["levels"] != LEVELS or "d_out" not in c:
            raise AssertionError(f"captured {name} layer: levels {c['levels']}, keys {sorted(c)}")
    sets = cfg.num_decoder_layers + 1
    if len(assignments) != 1 or tuple(assignments[0][0].shape) != (sets * 4, cfg.num_queries, trainer.max_gt):
        raise AssertionError(f"assignment calls in one train step: {[tuple(c.shape) for c, _ in assignments]}")
    captured["assignment"] = assignments[0]
    return captured


def baseline_library(csrc_dir):
    """The kernels built from another version of csrc/, for timing in turns;
    each entry point that the library has is bound by its own C signature
    (``hungarian_forward`` is the earlier assignment kernel's entry point,
    whose cost rows are exactly N floats long)."""
    lib = ctypes.CDLL(str(native.build(Path(csrc_dir).resolve())))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "msda_forward"):
        native.bind_msda(lib)
    signatures = {
        "grid_nms_forward": [ptr, native.LevelTable, ptr, i32, i32, i32, ptr],
        "assignment_forward": [ptr, ptr, ptr, i32, i32, i32, i32, ptr],
        "hungarian_forward": [ptr, ptr, ptr, i32, i32, i32, ptr],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i32
    return lib


def kernel_launchers(value, locs, weights, d_out):
    """Launch-only calls of K1 and K3 of a given library on these inputs
    (locations and weights cast to f32 once, outputs allocated once)."""
    B, S, C = value.shape
    Q, G = locs.shape[1:3]
    H, P = weights.shape[2], weights.shape[-1]
    loc32, attn32 = locs.float().contiguous(), weights.float().contiguous()
    out = torch.empty(B, Q, C, dtype=value.dtype, device=value.device)
    d_value = torch.zeros(B, S, C, device=value.device)
    d_loc, d_attn = torch.empty_like(loc32), torch.empty_like(attn32)
    table, bf16, stream = native.level_table(LEVELS), int(value.dtype == torch.bfloat16), native.stream_of(value)

    def forward(lib):
        native.check(lib.msda_forward(value.data_ptr(), bf16, table, loc32.data_ptr(), attn32.data_ptr(),
                                      out.data_ptr(), B, S, Q, C, H, G, P, stream), "msda_forward")

    def backward(lib):  # d_value keeps accumulating: the same atomics each call
        native.check(lib.msda_backward(value.data_ptr(), bf16, table, loc32.data_ptr(), attn32.data_ptr(),
                                       d_out.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
                                       d_attn.data_ptr(), B, S, Q, C, H, G, P, stream), "msda_backward")

    return forward, backward


def in_turns(run, base, new, iters):
    """Device ms of ``run(lib)`` for base, new, new, base."""
    return [cuda_ms(lambda: run(lib), iters) for lib in (base, new, new, base)]


def phase_msda_captured(smi, baselines, captured):
    """K1 and K3 on the inputs the flagship train step gives them at init,
    against the plain versions, with times; then, for each directory in
    ``baselines``, its K1 and K3 timed in turns with the shipped ones on the
    captured and the uniform inputs."""
    t0 = time.perf_counter()
    sets = {}
    for name in ("encoder", "decoder"):
        c = captured[name]
        value, locs, weights, d_out = c["value"], c["locations"], c["weights"], c["d_out"]
        G, Q, dtype = locs.shape[2], locs.shape[1], value.dtype
        in_level, nonzero, per_level = corner_counts(locs, LEVELS)
        got, want = ms_deform_attn(value, LEVELS, locs, weights), ms_deform_attn_plain(value, LEVELS, locs, weights)
        torch.cuda.synchronize()
        max_abs, _, bad, atol, rtol = compare(got, want, dtype)
        if bad:
            raise AssertionError(f"msda kernel disagrees with plain on the captured {name} inputs: {bad} elements")
        bwd_err, parts = backward_checks(value, locs, weights, d_out, f"captured {name}")
        fwd_ms = cuda_ms(lambda: ms_deform_attn(value, LEVELS, locs, weights), 20)
        bwd_ms = cuda_ms(lambda: _backward_cuda(value, LEVELS, locs, weights, d_out), 10)
        (fb, fby), (bb, bby) = msda_bounds(value, locs, weights)
        n = locs[..., 0].numel() * 4
        print(f"msda_captured: {name} layer 0 of a flagship train step at init, G={G} B={locs.shape[0]} Q={Q} "
              f"value {str(dtype)[6:]} weights {str(weights.dtype)[6:]}; corners in level {in_level / n:.4f}, "
              f"nonzero weight {nonzero / n:.4f} of all; nonzero adds per touched row by level (mean, max) "
              f"{[(round(m, 2), x) for m, x in per_level]}; K1 max_abs_err={max_abs:.3e} (atol {atol} rtol {rtol}) "
              f"kernel_ms={fwd_ms:.4f} bound_ms={fb:.4f} ({fby}); K3 {' '.join(parts)} kernel_ms={bwd_ms:.4f} "
              f"bound_ms={bb:.4f} ({bby}); card: {smi}")
        sets[f"captured {name}"] = (value, locs, weights, d_out)
    if baselines:
        gen = torch.Generator(device="cuda").manual_seed(9)
        for G, Q in ((1, 11403), (8, 1100)):
            value32, locs, weights = uniform_msda_inputs(gen, G, Q)
            d_out32 = torch.randn(value32.shape[0], Q, value32.shape[2], generator=gen, device="cuda")
            for dtype in (torch.bfloat16, torch.float32):
                sets[f"uniform G={G} Q={Q} {str(dtype)[6:]}"] = (value32.to(dtype), locs, weights, d_out32.to(dtype))
    new = native.load()
    for base_dir in baselines:
        base = baseline_library(base_dir)
        if not hasattr(base, "msda_forward"):
            continue
        for name, (value, locs, weights, d_out) in sets.items():
            forward, backward = kernel_launchers(value, locs, weights, d_out)
            k1 = in_turns(forward, base, new, 20)
            k3 = in_turns(backward, base, new, 10)
            (fb, _), (bb, _) = msda_bounds(value, locs, weights)
            print(f"msda_ab: {name} baseline={base_dir}: K1 ms base/new/new/base "
                  f"{[round(x, 4) for x in k1]} bound {fb:.4f}; K3 ms base/new/new/base "
                  f"{[round(x, 4) for x in k3]} bound {bb:.4f}; card: {smi}")
    print(f"msda_captured: phase_s={time.perf_counter() - t0:.2f}")


def capture_serve_topk():
    """The (B, K) candidates and num_out that a flagship serve forward (B=4,
    the 800x1344 canvas of TIMED_BATCH, random weights from seed 0) hands to
    ``grid_nms_topk``, recorded by a wrapper around the transformer's call."""
    cfg = load_config(DEFAULT_CONFIG)
    predictor = Predictor(cfg, None, "cuda", seed=0)
    inputs = preprocess(make_requests(TIMED_BATCH, 7), cfg, "cuda")
    calls, real = [], salience_transformer.grid_nms_topk

    def recording(topk_index, spatial_shapes, num_out):
        calls.append((topk_index.clone(), [tuple(x) for x in spatial_shapes], num_out))
        return real(topk_index, spatial_shapes, num_out)

    salience_transformer.grid_nms_topk = recording
    try:
        predictor.forward(*inputs)
    finally:
        salience_transformer.grid_nms_topk = real
    torch.cuda.synchronize()
    if len(calls) != 1 or calls[0][1] != LEVELS:
        raise AssertionError(f"grid NMS calls in one serve forward: {[c[1] for c in calls]}")
    return calls[0][0], calls[0][2]


def nms_chain_facts(topk, levels):
    """numpy, on the host, per image of (B, K) candidate orders: the
    candidates on each level, and the rounds of the synchronous fixpoint on
    each level (a candidate is suppressed one round after its first kept
    better-ranked 4-neighbour, kept one round after the last of them is
    suppressed; the kernel's in-place rounds take at most as many)."""
    shapes = np.asarray(levels)
    starts = np.concatenate([[0], np.cumsum(shapes[:, 0] * shapes[:, 1])])
    S = int(starts[-1])
    counts, rounds = [], []
    for row in topk.cpu().numpy().astype(np.int64):
        K = len(row)
        rank = np.full(S, K)
        rank[row] = np.arange(K)
        lvl = np.searchsorted(starts, row, side="right") - 1
        h, w = shapes[lvl, 0], shapes[lvl, 1]
        y, x = np.divmod(row - starts[lvl], w)
        nbs = np.stack([np.where(x > 0, rank[np.maximum(row - 1, 0)], K),
                        np.where(x + 1 < w, rank[np.minimum(row + 1, S - 1)], K),
                        np.where(y > 0, rank[np.maximum(row - w, 0)], K),
                        np.where(y + 1 < h, rank[np.minimum(row + w, S - 1)], K)], 1)
        kept, rnd = np.zeros(K, bool), np.zeros(K, np.int64)
        for r in range(K):
            nb = nbs[r][nbs[r] < r]
            hit = nb[kept[nb]]
            if hit.size:
                rnd[r] = 1 + rnd[hit].min()
            else:
                kept[r] = True
                rnd[r] = 1 + (rnd[nb].max() if nb.size else 0)
        counts.append(np.bincount(lvl, minlength=len(levels)).tolist())
        rounds.append([int(rnd[lvl == l].max(initial=0)) for l in range(len(levels))])
    return counts, rounds


def dijkstra_mirror(cost, valid):
    """numpy, on the host: the assignment kernel's algorithm (shortest
    augmenting paths with lazy potentials, f64, ties to the lowest query) on
    one image's (N, M) costs, with the kernel's order of operations.  Returns
    the Dijkstra steps it takes and the (M,) assignment (all -1 when some gt
    has no finite path)."""
    valid = valid.cpu().numpy()
    gts = np.flatnonzero(valid)
    rows = cost.float().cpu().numpy()[:, gts].T.astype(np.float64)  # (n, N)
    n, N = rows.shape
    u, v = np.zeros(n), np.zeros(N)
    row4col, col4row = np.full(N, -1), np.full(n, -1)
    out = np.full(len(valid), -1, np.int32)
    steps = 0
    for cur in range(n):
        d, scanned, path = np.full(N, np.inf), np.zeros(N, bool), np.full(N, -1)
        min_val, i = 0.0, cur
        while True:
            steps += 1
            r = (min_val - u[i]) + rows[i] - v
            better = ~scanned & (r < d)
            d[better], path[better] = r[better], i
            open_d = np.where(scanned, np.inf, d)
            j = int(np.argmin(open_d))
            if not np.isfinite(open_d[j]):
                return steps, out
            min_val, scanned[j] = open_d[j], True
            if row4col[j] < 0:
                sink = j
                break
            i = row4col[j]
        cols = np.flatnonzero(scanned)
        delta = min_val - d[cols]
        v[cols] -= delta
        for j, dj in zip(cols, delta):
            if j != sink:
                u[row4col[j]] += dj
        u[cur] += min_val
        j = sink
        while True:
            r_ = path[j]
            row4col[j] = r_
            col4row[r_], j = j, col4row[r_]
            if r_ == cur:
                break
    out[gts] = col4row
    return steps, out


def nms_launcher(topk, num_out):
    """A launch-only call of a library's grid-NMS kernel on these candidates
    (output allocated once); every version of it has one C signature."""
    B, K = topk.shape
    out = torch.empty(B, num_out, dtype=torch.int32, device=topk.device)
    table, stream = native.level_table(LEVELS), native.stream_of(topk)

    def run(lib):
        native.check(lib.grid_nms_forward(topk.data_ptr(), table, out.data_ptr(), B, K, num_out, stream),
                     "grid_nms_forward")

    return run, out


def assignment_launchers(cost, valid, sets):
    """Launch-only calls of a library's assignment kernel on the (sets * B,
    N, M) costs: all images in one launch, or one launch per set of B
    images; each library through its own C signature."""
    n_img, N, M = cost.shape
    B, ld = n_img // sets, -(-N // 4) * 4
    padded = torch.zeros(n_img, M, ld, device=cost.device)
    padded[..., :N] = cost.transpose(1, 2)
    exact = cost.float().transpose(1, 2).contiguous()
    flags = valid.to(torch.uint8).contiguous()
    out = torch.empty(n_img, M, dtype=torch.int32, device=cost.device)
    stream = native.stream_of(cost)

    def launch(lib, first, count):
        if hasattr(lib, "assignment_forward"):
            err = lib.assignment_forward(padded[first].data_ptr(), flags[first].data_ptr(),
                                         out[first].data_ptr(), count, N, M, ld, stream)
        else:
            err = lib.hungarian_forward(exact[first].data_ptr(), flags[first].data_ptr(),
                                        out[first].data_ptr(), count, N, M, stream)
        native.check(err, "assignment kernel")

    def batched(lib):
        launch(lib, 0, n_img)

    def per_set(lib):
        for s in range(sets):
            launch(lib, s * B, B)

    return batched, per_set, out


def same_output(run, out, base, new):
    run(base)
    first = out.clone()
    run(new)
    torch.cuda.synchronize()
    return torch.equal(first, out)


def phase_nms_assignment_captured(smi, baselines, assignment):
    """K2 on the candidates a flagship serve forward gives it and K4 on the
    stacked costs of a flagship train step at init, against their plain
    versions (and K4's totals against scipy), with the chain depths and
    Dijkstra steps that bound them, times and bounds; then, for each
    directory in ``baselines``, its K2 and K4 timed in turns with the shipped
    ones on these and on the phases' other inputs (K4: the baseline's one
    launch per set of 4 images against the shipped batched launch, then both
    batched)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    topk, num_out = capture_serve_topk()
    got = grid_nms_topk(topk, LEVELS, num_out)
    want = grid_nms_topk_plain(topk, LEVELS, num_out)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"grid_nms kernel differs from plain in {mismatches} entries on the captured inputs")
    ms = cuda_ms(lambda: grid_nms_topk(topk, LEVELS, num_out), 20)
    plain_ms = cuda_ms(lambda: grid_nms_topk_plain(topk, LEVELS, num_out), 3)
    # reads the top-k tokens, writes the kept ones; one comparison per token
    nms_t = (ms, plain_ms, *bound(nbytes(topk, got), topk.numel()))
    print(f"nms_captured: flagship serve forward at init, B={topk.shape[0]} K={topk.shape[1]} "
          f"num_out={num_out}; mismatches={mismatches} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={nms_t[2]:.6f} ({nms_t[3]}); card: {smi}")
    orders = {"captured serve": (topk, num_out), **{k: (t, NMS_OUT) for k, t in nms_orders(dev).items()}}
    for name, (t, _) in orders.items():
        counts, rounds = nms_chain_facts(t, LEVELS)
        print(f"nms_chains: {name}: candidates per level per image {counts}; "
              f"fixpoint rounds per (image, level) {rounds}")

    cost, valid = assignment
    n_img, N, M = cost.shape
    sets = n_img // 4
    got = batched_assignment(cost, valid)
    want = batched_assignment_plain(cost, valid)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    gaps = scipy_gaps(cost, got, valid)
    mirror = [dijkstra_mirror(cost[b], valid[b]) for b in range(n_img)]
    steps = np.asarray([m[0] for m in mirror]).reshape(sets, -1).tolist()
    mirror_mismatches = int((np.stack([m[1] for m in mirror]) != got.cpu().numpy()).sum())
    if mismatches or max(gaps) > 1e-3:
        raise AssertionError(f"assignment kernel differs on the captured costs: {mismatches} entries, "
                             f"cost gap {max(gaps)}")
    ms = cuda_ms(lambda: batched_assignment(cost, valid), 10)
    plain_ms = cuda_ms(lambda: batched_assignment_plain(cost, valid), 1)
    # reads the valid gts' costs and the mask, writes one query per gt slot;
    # at least one comparison per valid cost
    n_valid = int(valid.sum())
    hung_t = (ms, plain_ms, *bound(n_valid * N * 4 + nbytes(valid, got), n_valid * N))
    print(f"assign_captured: flagship train step at init, {sets} sets x B=4 stacked, N={N} M={M} "
          f"valid={GT_COUNTS}; mismatches={mismatches} total_cost_gap_vs_scipy={max(gaps):.3e}; "
          f"Dijkstra steps per (set, image) {steps} (host mirror of the kernel's algorithm, "
          f"{mirror_mismatches} entries differ from the kernel); one batched launch kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={hung_t[2]:.6f} ({hung_t[3]}); card: {smi}")

    new = native.load()
    assign_sets = {"captured train step": (cost, valid, sets),
                   **{f"valid={c}": (x, v, 1) for c, x, v in hungarian_costs(dev)}}
    for base_dir in baselines:
        base = baseline_library(base_dir)
        if hasattr(base, "grid_nms_forward"):
            for name, (t, n_out) in orders.items():
                run, out = nms_launcher(t, n_out)
                times = in_turns(run, base, new, 20)
                print(f"nms_ab: {name} baseline={base_dir}: K2 ms base/new/new/base "
                      f"{[round(x, 4) for x in times]} same_output={same_output(run, out, base, new)}; "
                      f"card: {smi}")
        if hasattr(base, "assignment_forward") or hasattr(base, "hungarian_forward"):
            for name, (c, v, n_sets) in assign_sets.items():
                batched, per_set, out = assignment_launchers(c, v, n_sets)
                both = in_turns(batched, base, new, 10)
                line = f"one launch of {c.shape[0]} images ms base/new/new/base {[round(x, 4) for x in both]}"
                if n_sets > 1:
                    turns = [cuda_ms(lambda: f(lib), 10)
                             for f, lib in ((per_set, base), (batched, new), (batched, new), (per_set, base))]
                    line = (f"base {n_sets} launches of 4 / new 1 launch of {c.shape[0]} / new / base "
                            f"{[round(x, 4) for x in turns]}; " + line)
                print(f"assign_ab: {name} baseline={base_dir}: K4 {line} "
                      f"same_output={same_output(batched, out, base, new)}; card: {smi}")
    print(f"nms_assignment_captured: phase_s={time.perf_counter() - t0:.2f}")
    return nms_t, hung_t


def phase_msda_stages(smi):
    """The shootout's entry point at the hot layer, counted; then K5-K8
    against their plain versions and the pipelines against K1 (uncounted)."""
    t0 = time.perf_counter()
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
    rc = stage_tool.main(["--q", "11403", "--iters", "3"])
    torch.cuda.synchronize()
    launches = {k: native.LAUNCHES[k] for k in STAGE_KERNELS}
    if rc != 0 or not all(launches.values()):
        raise AssertionError(f"msda_stages entry point: exit {rc}, stage launches {launches}")
    B, Q = 4, 11403
    parts, results = stage_checks(torch.device("cuda"), B, Q)
    print(f"msda_stages: entry point exit {rc}, stage launches {launches}; B={B} Q={Q} C=256 bf16 rows; "
          f"{'; '.join(parts)}; phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return launches, results


def stage_checks(dev, B, Q):
    """K5-K8 against their plain versions (times beside) and the pipelines
    against K1, on the shootout's inputs over LEVELS.  Returns the report's
    parts and, per kernel, (largest error, (ms, plain ms) of its first case)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    value, locs, w = stages.make_inputs(Q, LEVELS, B, generator=gen, device=dev)
    C = value.shape[-1]
    results, parts = {}, []

    def kernel_vs_plain(key, label, fn, plain, dtype, inputs=(), ops=0, library=None):
        """``inputs`` and ``ops``: what the kernel reads and computes (its
        output is added to the bytes); ``library``: one PyTorch call of the
        same function, timed as a yardstick."""
        got, want = fn(), plain()
        torch.cuda.synchronize()
        max_abs, _, bad, atol, rtol = compare(got, want, dtype)
        bound_ms, bound_by = bound(nbytes(*inputs, got), ops)
        del got, want
        ms, plain_ms = cuda_ms(fn, 10), cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 10) if library is not None else None
        parts.append(f"{label} max_abs_err={max_abs:.3e} (atol {atol} rtol {rtol}, violations {bad}) "
                     f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
                     + (f" library_ms={library_ms:.4f}" if library is not None else ""))
        if bad:
            raise AssertionError(f"{label}: the kernel disagrees with its plain version in {bad} elements")
        # the first case is the main path's
        worst, timing = results.get(key, (0.0, (ms, plain_ms, bound_ms, bound_by, library_ms)))
        results[key] = (max(worst, max_abs), timing)

    gv, gidx = stage_tool.gather_inputs(Q, LEVELS, gen, dev)
    gidx = gidx.permute(0, 2, 1, 3).contiguous()
    # library: one embedding_bag(mode="sum") over the (B*S*H, D) rows, bags of
    # flat row indices (b * S + s) * H + h
    Bg, Sg, Hg, Dg = gv.shape
    bags = ((torch.arange(Bg, device=dev).view(-1, 1, 1, 1) * Sg + gidx.long()) * Hg
            + torch.arange(Hg, device=dev).view(1, -1, 1, 1)).reshape(-1, gidx.shape[-1])
    table = gv.reshape(-1, Dg)
    kernel_vs_plain("gather_sum", f"K5 gather_sum (B,H,Q,G)={tuple(gidx.shape)} bf16",
                    lambda: stages.gather_sum(gv, gidx), lambda: stages.gather_sum_plain(gv, gidx),
                    torch.bfloat16, (gv, gidx), gidx.numel() * Dg,
                    lambda: torch.nn.functional.embedding_bag(bags, table, mode="sum"))
    del gv, gidx, bags, table

    base, wt = stages.quad_base_and_weights(locs, w, LEVELS)
    rows = stage_tool.gather_rows(stages.build_quad(value, LEVELS), base).reshape(B * Q, 16, 4 * C)
    N, I, KC = rows.shape
    H = wt.shape[-1]
    for wdtype in (torch.float32, torch.bfloat16):
        wq = wt.reshape(B * Q, 16, -1).to(wdtype)
        # library: one einsum over (item, corner) per (row, head), in bf16
        # (einsum takes one dtype; the bf16 weights are made before timing)
        wb = wq.to(torch.bfloat16).reshape(N, I, 4, H)
        kernel_vs_plain("weighted_reduce", f"K6 weighted_reduce quad rows weights {str(wdtype)[6:]}",
                        lambda: stages.weighted_reduce(rows, wq, 4),
                        lambda: stages.weighted_reduce_plain(rows, wq, 4), torch.float32,
                        (rows, wq), 2 * rows.numel(),
                        lambda: torch.einsum("nikhd,nikh->nhd", rows.view(N, I, 4, H, KC // 4 // H), wb))
    del rows, wt, wq, wb

    idx, cw, n_items, _ = stages.corner_blocked(locs, LEVELS, stage_tool.BLK)
    rows = torch.index_select(value.reshape(-1, C), 0, idx).reshape(cw.shape[0], -1, C)
    cw = cw.reshape(cw.shape[0], -1)
    groups, blk4 = cw.shape
    cwb = cw.to(torch.bfloat16).view(groups, 4, blk4 // 4)
    for out in (torch.float32, torch.bfloat16):
        # library: one einsum over the four corner blocks, in bf16 (all
        # groups, padding items included)
        kernel_vs_plain("corner_collapse_blocked", f"K7 corner_collapse_blocked out {str(out)[6:]}",
                        lambda: stages.corner_collapse_blocked(rows, cw, n_items, out),
                        lambda: stages.corner_collapse_blocked_plain(rows, cw, n_items, out), out,
                        (rows, cw), 8 * n_items * C,
                        lambda: torch.einsum("gkjc,gkj->gjc", rows.view(groups, 4, blk4 // 4, C), cwb))
    del rows, cw, cwb

    idx, cw = stages.corners_pmajor(locs, LEVELS)
    rows = stage_tool.gather_rows(value, idx).reshape(n_items, 4 * C)
    cw = cw.reshape(n_items, 4)
    cwb = cw.to(torch.bfloat16)
    for wdtype, out in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                        (torch.bfloat16, torch.bfloat16)):
        wp = cw.to(wdtype)
        # library: one einsum over the four corners, in bf16
        kernel_vs_plain("corner_collapse_packed",
                        f"K8 corner_collapse_packed weights {str(wdtype)[6:]} out {str(out)[6:]}",
                        lambda: stages.corner_collapse_packed(rows, wp, out),
                        lambda: stages.corner_collapse_packed_plain(rows, wp, out), out,
                        (rows, wp), 8 * n_items * C,
                        lambda: torch.einsum("nkc,nk->nc", rows.view(n_items, 4, C), cwb))
    del rows, cw, wp, cwb

    k1 = ms_deform_attn(value, LEVELS, locs[:, :, None].contiguous(), w).float()
    for name, fn in stage_tool.PIPELINES.items():
        err = (fn(value, LEVELS, locs, w).float() - k1).abs()
        limit = stage_tool.CHECK_ATOL + stage_tool.CHECK_RTOL * k1.abs()
        ratio = float((err / limit).max())
        parts.append(f"{name}_vs_K1 max_abs_err={float(err.max()):.3e} max_err/bound={ratio:.3e}")
        if ratio > 1:
            raise AssertionError(f"pipeline {name} disagrees with K1 beyond rtol 0.05 / atol 0.02")
    return parts, results


def kernel_entry(name, source, replaces, launches, err, timing):
    ms, plain_ms, bound_ms, bound_by, *library = timing
    return {"name": name, "route": "cuda", "source": f"salience_detr_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library[0] if library else None}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-csrc", nargs="*", default=[], metavar="DIR",
                        help="directories holding another version of csrc/, whose MSDA, grid-NMS and "
                             "assignment kernels are timed in turns with these on the captured inputs "
                             "and the phases' other inputs")
    args = parser.parse_args(argv)
    smi = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    msda_err, msda_t = phase_msda()
    phase_grid_nms()
    phase_slice()
    serve_launches = phase_serve(smi)
    bwd_err, bwd_t = phase_msda_backward()
    phase_hungarian()
    phase_train_slice()
    train_launches = phase_train(smi)
    captured = capture_train_inputs()
    phase_msda_captured(smi, args.baseline_csrc, captured)
    nms_t, hung_t = phase_nms_assignment_captured(smi, args.baseline_csrc, captured.pop("assignment"))
    del captured
    stage_launches, stage_results = phase_msda_stages(smi)
    print(f"serve launches {serve_launches}; train launches {train_launches}; "
          f"msda_stages launches {stage_launches}")
    # K1-K4: no single PyTorch call computes them (MSDA is a grid_sample per
    # level and a weighted sum; PyTorch has no NMS or assignment op).  K2 and
    # K4 are exact, and timed on the main path's own inputs (phase 12).
    kernels = [
        kernel_entry("msda_forward", "msda.cu", "salience_detr_tpu/ops/deform_attn.py:768",
                     train_launches["msda"], msda_err, msda_t),
        kernel_entry("grid_nms_forward", "grid_nms.cu", "salience_detr_tpu/ops/nms.py:68",
                     train_launches["grid_nms"], 0.0, nms_t),
        kernel_entry("msda_backward", "msda_backward.cu", "salience_detr_tpu/ops/deform_attn.py:666",
                     train_launches["msda_backward"], bwd_err, bwd_t),
        kernel_entry("assignment_forward", "hungarian.cu", "salience_detr_tpu/ops/hungarian.py:36",
                     train_launches["hungarian"], 0.0, hung_t),
    ]
    for name, source, replaces in (
        ("gather_sum", "gather_sum.cu", "tools/bench_gather.py:64"),
        ("weighted_reduce", "weighted_reduce.cu", "tools/bench_msda2.py:201, tools/bench_msda3.py:44"),
        ("corner_collapse_blocked", "corner_collapse.cu", "tools/bench_msda2.py:638"),
        ("corner_collapse_packed", "corner_collapse.cu",
         "tools/bench_msda2.py:677, tools/bench_msda5.py:73, tools/bench_msda5.py:165"),
    ):
        err, timing = stage_results[name]
        kernels.append(kernel_entry(name, source, replaces, stage_launches[name], err, timing))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
