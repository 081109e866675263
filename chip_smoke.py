#!/usr/bin/env python3
"""Drive the PyTorch port (salience_detr_torch) on one CUDA card.

    python3 chip_smoke.py [--baseline-csrc DIR [DIR ...]] [--phases NAME ...]

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
12b. mixed_assignment: the mixed (Align-DETR) assignment on K4 at C = 2 and
   C = 10 (C * M = 1000 > N = 900) on phase 12's captured costs, one launch
   each, against the plain version over the tiled columns: the same queries
   for each gt and equal totals (which copy takes which query is a tie);
   the wrapper's and launch-only times beside the plain entry's (C = 1),
   bounds; then phase 10's flagship step with ``SetCriterion(
   mixed_match_copies=2)`` built directly: one assignment launch a step;
13. msda_groups (after phase 7): K1 and K3 at G=2 and G=4 location groups at
   the encoder's flagship shape (B=4, Q=11403, bf16), against their plain
   versions, with times and bounds;
14. nms_keep: the greedy NMS keep-mask kernel (K9, a thread-block cluster
   an image) against its plain version, exactly, on the post-process boxes
   of a flagship serve forward (B=4, N=300) at IoU thresholds 0.5 and 0.7,
   on a chain of boxes, on identical boxes and on random boxes at N = 300,
   600, 1024, 1400 and 4096, with times (launch only, the fill alone, the
   wrapper) and bounds, and every placement of the conflict rows at
   clusters of 8 and 16 blocks held and timed (``nms_keep_variants:``);
   with ``--baseline-csrc``, each directory's keep-mask kernel timed in
   turns with this one on every case (``keep_ab:``);
15. eval: the evaluation path (python -m salience_detr_torch.test) on a
   COCO-format split of 8 .npy images of mixed sizes and orientations written
   under build/chip_smoke_eval/: the flagship in exact mode from a strict load
   of a seed-initialised exact-mode state dict, with the NMS and confidence
   filters on, through the entry point's functions; then the entry point's
   ``main`` on the hybrid flagship with the filters off, its saved
   predictions re-scored to the same stats.  Launches per forward: 12 MSDA,
   1 grid NMS, 1 or 0 NMS keep mask; the 12 stats finite; K1 held on the
   exact-mode encoder inputs (G=8, Q=11403); wall seconds and img/s;
15b. train_coco: the train CLI's ``main`` on a COCO-format split of 20
   .npy images written under build/ (the flagship, bf16, B=4, both
   canvases, the detr preset): 4 steps and an eval, a resume, an
   accumulated step, fp16 epochs; per step 12 K1, 12 K3, 1 K2 and 1 K4
   launches; host transform ms a sample, loader wait, step wall, peak;
15c. train_coco_strong: phase 15b's first run with ``strong_album`` and
   ``copypaste`` (instance masks from polygon segmentations) and ``cv2``
   blocked from import, 3 steps and the eval: the same launches a step,
   finite losses, the host transform ms a sample beside 15b's, the loader
   wait, step wall and peak memory;
16. msda_stages: the staged MSDA shootout's entry point
   (python -m salience_detr_torch.tools.msda_stages --q 11403 --iters 3:
   every pipeline checked against the plain MSDA at Q=256, then timed beside
   K1, the kernel-only timings and the row-width scan); its launch counters
   must show each stage kernel K5-K8 launched.  Then, at the hot layer (B=4,
   Q=11403, bf16 rows), each stage kernel against its plain version with
   times, bound and one library call of the same function (K6 with f32 and
   bf16 weights, K7 and K8 with f32 and bf16 outputs, K8 with bf16 weights),
   and each of the seven pipelines against K1 within the shootout's check
   bound (rtol 0.05, atol 0.02); the K5 part prints the row bytes it reads
   from L2.  With ``--baseline-csrc``, ``gather_ab:`` lines: each
   directory's K5 in turns with the shipped one at the hot shape, on the
   shootout's uniform indices and on level-shaped ones (the corners of its
   locations), outputs bitwise equal, with both shares of the bound and the
   L2 row bytes each leaves; the cluster-staged design
   (salience_detr_torch/tools/gather_cluster) at each staging variant.  The
   serve and train phases' counters show no stage-kernel launch;
17. deform_conv (after phase 15): the DCNv2 kernels (B6) at each distinct
   DCN layer shape of the R50-DCN config (B=4, 800x1344 canvas; stages 2-4,
   stride 2 and 1) on offsets spanning a few pixels (some taps outside the
   image) and masks in (0, 1): the columns kernel bitwise equal to its plain
   version in float32 (TF32 off) and bfloat16, the backward against the plain
   backward and autograd of the plain forward; times, bounds and
   F.grid_sample's times (the library yardstick); then the 16-bit layer
   (``deform_conv_fused:``, a (9, C, C) kernel): ``deform_conv2d``'s route
   (the fused kernel alone at F = 128, the columns kernel alone at F = 256
   and 512) in bf16 and f16, and the fused kernel at every shape against the
   plain layer and, beside the parent's path (the columns kernel, then
   torch.matmul), against the f32 product of the same columns; the kernel in
   turns with that path (parent, fused, fused, parent), with the path's two
   parts, the plain time and the bound at the bf16 tensor-core rate; the
   totals over the 13 layers of the kernel, of the parent's path and of the
   route.  With ``--baseline-csrc``, each directory's DCN kernels timed in
   turns with these (``dcn_ab:``; the columns kernel launch only, its output
   held equal, with its share of the bound; the backward as whole calls, each
   baseline's gradients held against the plain backward; the fused kernel
   against the baseline's columns kernel + torch.matmul, and launch only
   against the baseline's own fused kernel, with its error against the
   plain layer);
17b. dcn_captured: the backward on the inputs of the 13 DCN layers of one
   R50-DCN train step (offset and mask convs at seeded small normals), and
   on the same with offsets of std 8 px: against the plain backward and
   autograd, d_x bitwise repeatable, the gather's list sizes, times and
   bounds per layer and over the 13; with ``--baseline-csrc``, each
   directory's backward (the earlier per-corner atomic push, the halo push
   of tools/dcn_halo/, ...) in turns as whole calls; then the 16-bit
   layer's two routes on the captured layers' own x, offsets, mask and
   kernel (the fused kernel within one ulp + 1e-3 of the plain layer, then
   in turns with the columns kernel + torch.matmul, per layer and summed by
   F: what ``FUSED_MAX_F`` follows);
18. dcn_slice: phases 5 and 9 on the small model with DCN stages 2-4, its
   offset and mask convs at seeded small normals (``offsets_off_grid``) on
   both devices; then its train step on the card under float16 autocast:
   finite losses; of its 6 DCN layers the two at F = 128 take the fused
   kernel and the four at F = 256, 512 the columns kernel, then 6 columns
   (the recompute) and 6 gather launches in backward; every DCN parameter
   moves;
19. dcn_serve: R50-DCN (configs/salience_detr_torch/
   salience_detr_resnet50_dcn_800_1333.py) served as in phase 6, its offset
   and mask convs at seeded small normals: per forward 4 fused DCN launches
   (stage 2, F = 128) and 9 columns launches (stages 3-4), 12 MSDA and 1
   grid-NMS launch; identical reruns; timed forwards;
20. dcn_train: R50-DCN trained as in phase 10: per step also 4 fused DCN
   forward, 9 + 13 columns (stages 3-4's forward and every layer's recompute
   in backward) and 13 DCN backward launches; every DCN parameter moves;
   peak memory;
21. msda_q8: the int8 head-shared MSDA kernels (B8, quantise and sample) at
   the encoder's flagship shape (B=4, Q=11403, G=1, bf16) on uniform inputs
   and on a served forward's captured encoder-layer-0 inputs: the int8 table
   and scale exactly equal to the plain quantisation's, the sampler bitwise
   equal to its plain version, the result against K1 within the quantisation
   bound; times, K1's time and bounds.  With ``--baseline-csrc``, ``q8_ab:``
   lines (the quantise kernels in turns, their tables and scales held equal,
   with their shares of the bound; the samplers in turns);
22. serve_q8: the flagship served with MSDA_GATHER_QUANT=int8 (the JAX
   package's switch): per forward 6 quantise, 6 int8 sample, 6 MSDA (the
   decoder) and 1 grid-NMS launch; identical reruns; the timed batch with
   the switch on and off in turns, and the gap between their detections;
22b. tools (after phase 22): the user tools on the flagship (seed-0
   weights, 800x1344, bf16, B=1), each through the function its CLI calls:
   benchmark_model (parameters, FLOPs by FlopCounterMode with the MSDA
   operator's formula, peak memory, CUDA-event latency and img/s); export
   with --with-postprocess (torch.export, saved and loaded, the graph's
   kernel operators listed, 12 K1 and 1 K2 launches counted inside the
   loaded program, which holds the live model at rtol 1e-3 / atol 1e-5, and
   ExportedDetector against Predictor on a 480x640 image); the salience
   maps and a Grad-CAM with their launches (12 K1, 1 K2; the CAM adds 12
   K3), the CAM finite and nonzero; the small model's CAM card-vs-CPU; the
   inference CLI's --show-dir refusing by name without cv2.  It prints its
   seconds;
23. nms_past_budget (after phase 16, msda_stages): K2 at the 5-scale levels
   of the 800x1344 canvas (S = 89,250, the rank map in shared memory) and of
   a 1344x1344 canvas (S = 149,940, past the shared memory: the rank map in
   global memory), and K9 at N = 1024 (the conflict rows in the walking
   block's shared memory), 1400, 2048 and 4096 (in the filling blocks'),
   spread and crowded, exactly against their plain versions, with times;
24. backbone_slice: phases 5 and 9 for the backbone families, small archs
   with stochastic depth 0 registered in the port's tables: the forward
   card-vs-CPU with a ResNeXt, ConvNeXt, Swin v1, Swin v2, FocalNet, ViT and
   EVA-02 backbone, one train step of the Swin model, and ``DropPath`` on the
   card (whole rows, 1 / keep, one draw per generator state);
25. msda_backbone_shapes: K1 and K3 against their plain versions on the
   inputs of encoder and decoder layer 0 of one train step at init of the
   R50 5-scale config (exact G=8, S=89,250) and of Swin-L (exact G=8,
   S=22,323), with times and bounds;
26. serve_<cfg> for swin_l, convnext_l, focalnet_l, r50_5scale (the configs
   under configs/salience_detr_torch/) and eva02_b (the flagship with the
   EVA-02-B backbone, no config file): phase 6 on each (B=4, 800x1344, bf16,
   seeded weights: 12 MSDA and 1 grid-NMS launch per forward, identical
   reruns, the median of 3 timed forwards, peak memory);
27. train_<cfg> for the four shipped configs: phase 10 with a warm-up and 2
   timed steps (12 MSDA forward and backward, 1 grid-NMS and 1 assignment
   launch a step; finite losses; every trainable backbone parameter moves,
   or, where its gradients stay far below Adam's eps (ConvNeXt's blocks
   under their 1e-6 layer scale at init), has a nonzero Adam first moment
   and a step below its float32 resolution, the count printed; peak memory);
28. eval_swin_l: salience_detr_torch.test.main on the Swin-L config with
   --torch-checkpoint (exact mode) over phase 15's split, from a saved
   seed-1 state dict that also holds upstream Swin's attention buffers,
   which the loader drops by name before its strict load; 12 MSDA and 1
   grid-NMS launch a forward, the stats finite.

``--phases steps_e2e`` (not in the full run) reads end-to-end device times
beside the K3 and B6 kernels': a deterministic flagship and R50 5-scale
train step, an R50-DCN serve forward with both 16-bit routes in turns and
an R50-DCN train step; it uses only what earlier commits also have, so a
copy of this script in an earlier checkout times that commit's package.

Then the total wall time.  The line before the last is {"kernels": [...]}: per kernel its launches in
the counted train steps (3; K4 launches once a step: in phase 15b's first
run, phase 15c and phase 12b's mixed step; K9 in the eval phase's
first run; the DCN kernels in phase 20's steps, the int8 kernels in phase
22's 6 forwards), its largest error, its time, its plain version's
time, its bound (``bound_ms``: bytes over 3.35 TB/s or f32 operations over
67 TFLOP/s, whichever is larger, ``bound_by`` which; the fused DCN layer's
operations over the 989 TFLOP/s of bf16 tensor cores) and the time of one
PyTorch call of the same function (``library_ms``, null where there is
none).  The last line is {"ok": true, "device": {...}}.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from salience_detr_torch import native
from salience_detr_torch import test as eval_entry
from salience_detr_torch.data.coco import CocoDetection, CocoIndex
from salience_detr_torch.data.loader import DetectionLoader, DevicePrefetcher, to_device
from salience_detr_torch.engine.train import evaluate, train_one_epoch
from salience_detr_torch.inference import DEFAULT_CONFIG, Predictor, load_config, preprocess
from salience_detr_torch.models.bricks import attention, salience_transformer
from salience_detr_torch.models.bricks import criterion as criterion_module
from salience_detr_torch.models.bricks import deform_conv as dcn_module
from salience_detr_torch.models.bricks.attention import MultiScaleDeformableAttention
from salience_detr_torch.models.bricks.criterion import Targets, compute_matching_cost
from salience_detr_torch.models.bricks.deform_conv import DeformConv2dPack
from salience_detr_torch.models.bricks.denoising import cdn_draws
from salience_detr_torch.models.backbones import convnext as convnext_bb
from salience_detr_torch.models.backbones import focalnet as focalnet_bb
from salience_detr_torch.models.backbones import resnet as resnet_bb
from salience_detr_torch.models.backbones import swin as swin_bb
from salience_detr_torch.models.backbones import vit as vit_bb
from salience_detr_torch.models.bricks.post_process import PostProcess
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr, exact_sampling
from salience_detr_torch.models.layers import DropPath
from salience_detr_torch.ops import msda_stages as stages
from salience_detr_torch.ops import deform_conv as dcn_ops
from salience_detr_torch.ops.deform_attn import (
    _backward_cuda,
    _backward_cuda_ordered,
    backward_design,
    ms_deform_attn,
    ms_deform_attn_backward_plain,
    ms_deform_attn_plain,
    ms_deform_attn_q8,
    ms_deform_attn_q8_plain,
    q8_quantize,
    q8_quantize_plain,
    q8_sample,
    q8_sample_plain,
)
from salience_detr_torch.ops.boxes import box_iou_pairwise
from salience_detr_torch.ops.hungarian import (
    batched_assignment,
    batched_assignment_plain,
    batched_mixed_assignment,
    batched_mixed_assignment_plain,
    copy_counts,
)
from salience_detr_torch.ops.nms import (
    NMS_KEEP_ROWS,
    SMEM_OPTIN_BYTES,
    grid_nms_rank_in_global,
    grid_nms_topk,
    grid_nms_topk_plain,
    nms_keep_mask,
    nms_keep_mask_plain,
    nms_keep_plan,
    nms_keep_smem_bytes,
)
from salience_detr_torch.parallel import mesh as ddp_mesh
from salience_detr_torch.parallel.train_step import make_eval_step
from salience_detr_torch.timing import card_line, cuda_ms, cuda_times, queued_ms
from salience_detr_torch.tools import benchmark_model as bench_tool
from salience_detr_torch.tools import ddp_check
from salience_detr_torch.tools import export as export_tool
from salience_detr_torch.tools import feature_viz as feature_viz_tool
from salience_detr_torch.tools import grad_cam as grad_cam_tool
from salience_detr_torch.tools import msda_stages as stage_tool
from salience_detr_torch import train as train_entry
from salience_detr_torch.parallel import train_step as train_step_module
from salience_detr_torch.train import GT_COUNTS, TRAIN_CONFIG, Trainer
from salience_detr_torch.utils.checkpoint import CheckpointManager
from salience_detr_torch.utils.config import Config
from salience_detr_torch.utils.env import configure_numerics
from salience_detr_torch.utils.coco_eval import METRIC_NAMES, CocoEvaluator

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
BF16_TENSOR_OPS_PER_MS = 989e12 / 1e3  # dense bf16 and f16 tensor-core rate
STAGE_KERNELS = ("gather_sum", "weighted_reduce", "corner_collapse_blocked", "corner_collapse_packed")
NO_STAGE_LAUNCHES = {k: 0 for k in STAGE_KERNELS}
# f32 operations of one pair's IoU test: 4 max/min, 2 differences and their
# clamps, the intersection, union (2) and its clamp, the quotient, the compare
IOU_OPS = 14
# the eval phase's split: the first two serve batches' sizes (5 landscape, 3
# portrait), and where it is written (an ignored directory of the checkout)
EVAL_SIZES = SERVE_BATCHES[0] + SERVE_BATCHES[1]
EVAL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
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


def msda_bounds(value, locs, weights, levels=LEVELS):
    """Bounds of K1 and K3 on these inputs.  K1 reads value, locations and
    weights (f32, as the kernel takes them) and writes (B, Q, C) in the value
    dtype; 2 operations per channel of each nonzero-weight corner.  K3 also
    reads d_out and writes d_value (f32), d_locations and d_weights (f32);
    2 operations per channel for each in-level corner's dot product and 2 for
    each nonzero-weight corner's scatter."""
    B, S, C = value.shape
    Q, G = locs.shape[1:3]
    in_level, nonzero, _ = corner_counts(locs, levels)
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


def phase_slice(name="slice", stage_with_dcn=(False,) * 4, fields=None):
    """Small random-weight model, float32: card (kernels) vs CPU (plain).
    With DCN stages, their offset and mask convs get the same seeded small
    normal weights on both devices, so the taps sample off the pixel grid.
    ``fields`` replace SMALL's (another backbone)."""
    cfg = SalienceDETRConfig(**{**SMALL, **(fields or {})}, stage_with_dcn=stage_with_dcn)
    cpu = Predictor(cfg, None, "cpu", seed=3)
    gpu = Predictor(cfg, None, "cuda", seed=3)
    if any(stage_with_dcn):
        offsets_off_grid(cpu.model)
        offsets_off_grid(gpu.model)
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
    print(f"{name}: tiny float32 card-vs-cpu backbone={cfg.backbone} stage_with_dcn={stage_with_dcn} "
          f"same_proposals={same_proposals} "
          f"max_abs_err={errs} rtol=1e-3 atol=1e-3")
    if not ok:
        raise AssertionError(f"{name}: small-model forward on the card disagrees with the CPU forward")


def offsets_off_grid(model, seed=20, std=0.5):
    """Seeded normal weights, ``std`` / sqrt(fan in), for the offset and mask
    convs of every DCN layer of ``model``, through a strict state-dict load.
    The JAX init zeroes them, which puts every tap on its pixel, where a
    wrong interpolation, border or corner derivative shows no error."""
    gen = torch.Generator().manual_seed(seed)
    sd = model.state_dict()
    for name, m in model.named_modules():
        if isinstance(m, DeformConv2dPack):
            for part in ("conv_offset", "conv_mask"):
                key = f"{name}.{part}.weight"
                sd[key] = torch.randn(sd[key].shape, generator=gen) * (std / math.sqrt(sd[key][0].numel()))
    model.load_state_dict(sd, strict=True)


def make_requests(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


def phase_serve(smi, name="serve", cfg=None, label="flagship R50", prepare=None, per_forward=None):
    """``cfg`` (the flagship by default) through ``Predictor``; ``prepare``
    edits the model before the run (a strict state-dict load); per forward
    12 MSDA and 1 grid-NMS launch unless ``per_forward`` says otherwise.
    Returns the launches, the predictor and the timed batch's inputs."""
    cfg = cfg or load_config(DEFAULT_CONFIG)
    predictor = Predictor(cfg, None, "cuda", seed=0)
    if prepare is not None:
        prepare(predictor.model)
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
    expect = {k: 0 for k in native.LAUNCHES}
    expect.update(msda=layers * forwards, grid_nms=forwards)
    expect.update({k: v * forwards for k, v in (per_forward or {}).items()})
    if launches != expect:
        raise AssertionError(f"{name}: launch counts {launches} for {forwards} forwards")
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    print(f"{name}: {label} bf16, {len(batches)} batches of 4 requests in {forwards} forwards; "
          f"launches={launches}; identical_rerun={identical}; warmup_s={warmup_s:.2f}; "
          f"B=4 canvas={canvas[0]}x{canvas[1]} forward_ms={[round(x, 3) for x in times]} "
          f"median_ms={med:.3f} img_s={4000.0 / med:.3f} peak_mem_gib="
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f}; card: {smi}")
    return launches, predictor, inputs


def compare_bwd(got, want):
    atol_rel, rtol = BWD_TOL[want.dtype]
    ref = want.float()
    err = (got.float() - ref).abs()
    scale = float(ref.abs().max())
    bad = int((err > atol_rel * scale + rtol * ref.abs()).sum())
    return float(err.max()), scale, bad, atol_rel, rtol


def backward_checks(value, locs, weights, d_out, label, levels=LEVELS):
    """K3 through autograd (counted) against the plain backward and against
    autograd of the plain forward.  Returns the largest error and the
    report's parts; raises on a violation."""
    inputs = [x.clone().requires_grad_() for x in (value, locs, weights)]
    before = native.LAUNCHES["msda_backward"]
    ms_deform_attn(inputs[0], levels, inputs[1], inputs[2]).backward(d_out)
    torch.cuda.synchronize()
    if native.LAUNCHES["msda_backward"] != before + 1:
        raise AssertionError("the MSDA backward kernel did not run")
    got = [x.grad for x in inputs]
    plain = ms_deform_attn_backward_plain(value, levels, locs, weights, d_out)
    auto = [x.clone().requires_grad_() for x in (value, locs, weights)]
    ms_deform_attn_plain(auto[0], levels, auto[1], auto[2]).backward(d_out)
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


def phase_msda_groups(smi):
    """K1 and K3 at G=2 and G=4 location groups (the JAX grouped core, 1 < G
    < H) at the encoder's flagship shape (B=4, Q=11403, S=22323, bf16,
    uniform inputs), against their plain versions (K3 also against autograd
    of the plain forward), with times and bounds."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    S, Q = sum(h * w for h, w in LEVELS), 11403
    for G in (2, 4):
        value32, locs, weights = uniform_msda_inputs(gen, G, Q)
        value = value32.to(torch.bfloat16)
        d_out = torch.randn(value.shape[0], Q, value.shape[2], generator=gen, device=dev).to(torch.bfloat16)
        del value32
        got, want = ms_deform_attn(value, LEVELS, locs, weights), ms_deform_attn_plain(value, LEVELS, locs, weights)
        torch.cuda.synchronize()
        max_abs, _, bad, atol, rtol = compare(got, want, torch.bfloat16)
        if bad:
            raise AssertionError(f"msda kernel disagrees with plain at G={G} bf16: {bad} elements")
        del got, want
        _, parts = backward_checks(value, locs, weights, d_out, f"G={G} bf16")
        fwd_ms = cuda_ms(lambda: ms_deform_attn(value, LEVELS, locs, weights), 20)
        fwd_plain = cuda_ms(lambda: ms_deform_attn_plain(value, LEVELS, locs, weights), 5)
        bwd_ms = cuda_ms(lambda: _backward_cuda(value, LEVELS, locs, weights, d_out), 10)
        bwd_plain = cuda_ms(lambda: ms_deform_attn_backward_plain(value, LEVELS, locs, weights, d_out), 3)
        (fb, fby), (bb, bby) = msda_bounds(value, locs, weights)
        print(f"msda_groups: G={G} B={value.shape[0]} Q={Q} S={S} C={value.shape[2]} bf16 uniform; "
              f"K1 max_abs_err={max_abs:.3e} (atol {atol} rtol {rtol}) kernel_ms={fwd_ms:.4f} "
              f"plain_ms={fwd_plain:.4f} bound_ms={fb:.4f} ({fby}); K3 {' '.join(parts)} kernel_ms={bwd_ms:.4f} "
              f"plain_ms={bwd_plain:.4f} bound_ms={bb:.4f} ({bby}); card: {smi}")


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


def small_train_step(device, counts=(3, 1), stage_with_dcn=(False,) * 4, fields=None):
    """One train step of the small model (``fields`` replacing SMALL's) on
    ``device`` from seed 6; returns (metrics, assignments, clipped
    gradients, parameters, buffers, calls of the criterion's batched
    matching, parameters before the step)."""
    cfg = SalienceDETRConfig(**{**SMALL, **(fields or {})}, denoising_nums=4, stage_with_dcn=stage_with_dcn)
    tc = Config(str(TRAIN_CONFIG), max_gt=6, train_canvas=(96, 128)).to_dict()
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
    # likewise the DCN taps (zero offset convs put every tap on its pixel)
    offsets_off_grid(trainer.model)
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
    model = trainer.model
    before = {n: p.detach().cpu() for n, p in model.named_parameters()}
    metrics = trainer.step(batch, draws=draws)
    return (
        {k: float(v) for k, v in metrics.items()},
        [m.cpu() for m in matches],
        {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None},
        {n: p.detach().cpu() for n, p in model.named_parameters()},
        {n: b.cpu() for n, b in model.named_buffers()},
        len(calls),
        before,
    )


def phase_train_slice(name="train_slice", stage_with_dcn=(False,) * 4, fields=None):
    """Small random-weight model, float32: a train step on the card (kernels)
    vs the same step on the CPU (plain versions)."""
    gpu = small_train_step("cuda", stage_with_dcn=stage_with_dcn, fields=fields)
    cpu = small_train_step("cpu", stage_with_dcn=stage_with_dcn, fields=fields)
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
    print(f"{name}: small float32 train step card-vs-cpu backbone={(fields or SMALL)['backbone']} "
          f"stage_with_dcn={stage_with_dcn} assignments={len(gpu[1])} "
          f"in {gpu[5]} batched matching call(s) "
          f"same_assignments={same_matches} max_loss_rel_err={loss_err:.3e} (rtol 1e-4) "
          f"grad_err/bound={grad_ratio:.3e} at {worst_grad} (bound 1e-3*max|g|+1e-6) "
          f"param_max_abs_err={param_err:.3e} (atol 1e-6) buffer_max_abs_err={buffer_err:.3e} (atol 1e-5) "
          f"same_grad_set={set(gpu[2]) == set(cpu[2])}")
    if not (same_matches and len(gpu[1]) == 3 and gpu[5] == cpu[5] == 1 and loss_err <= 1e-4 and grad_ratio <= 1.0
            and param_err <= 1e-6 and buffer_err <= 1e-5 and set(gpu[2]) == set(cpu[2])):
        raise AssertionError(f"{name}: the small train step on the card disagrees with the CPU step")


def adam_step_below_resolution(optimizer, p):
    """Whether ``p`` had a nonzero gradient (Adam's first moment) and its
    last AdamW step, lr * m_hat / (sqrt(v_hat) + eps) plus the decoupled
    decay, is below half the float32 spacing of its value everywhere, so
    that leaving it unchanged is right."""
    st = optimizer.state[p]
    group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
    t, (b1, b2) = float(st["step"]), group["betas"]
    m_hat, v_hat = st["exp_avg"] / (1 - b1 ** t), st["exp_avg_sq"] / (1 - b2 ** t)
    value = p.detach().abs()
    step = group["lr"] * (m_hat.abs() / (v_hat.sqrt() + group["eps"]) + group["weight_decay"] * value)
    spacing = torch.nextafter(value, torch.full_like(value, math.inf)) - value
    return bool(st["exp_avg"].abs().max() > 0) and bool((step < spacing / 2).all())


def phase_train(smi, name="train", cfg=None, label="flagship R50", prepare=None, per_step_extra=None,
                must_move=(), timed=3, counts=GT_COUNTS, sub_ulp_ok=False, criterion=None):
    """``cfg`` (the flagship by default) through ``Trainer``: a warm-up step,
    then ``timed`` counted steps on batches with ``counts`` valid gts per
    image; ``prepare`` edits the model before the run; ``criterion``, when
    given, replaces the train step's SetCriterion; every trainable
    parameter whose name contains one of ``must_move`` has to move (with
    ``sub_ulp_ok``, or have a nonzero Adam first moment, its steps below the
    float32 resolution of its value)."""
    cfg = cfg or load_config(DEFAULT_CONFIG)
    # the criterion matches all 7 sets (6 decoder layers, the encoder) in one launch
    per_step = {k: 0 for k in native.LAUNCHES}
    per_step.update(msda=12, msda_backward=12, grid_nms=1, hungarian=1, **(per_step_extra or {}))
    trainer = Trainer(cfg, "cuda", seed=0, steps_per_epoch=1 + timed)
    if criterion is not None:
        trainer.step.criterion = criterion
    if prepare is not None:
        prepare(trainer.model)
    batches = list(trainer.batches(1 + timed, seed=0, counts=counts))
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
        raise AssertionError(f"{name}: launch counts {launches} for {timed} train steps")
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
    named = [(n, p) for n, p in trainer.model.named_parameters() if any(m in n for m in must_move)]
    unmoved = [(n, p) for n, p in named if p.requires_grad and torch.equal(p.detach(), before[n])]
    # A parameter whose gradients stay far below Adam's eps takes steps below
    # the float32 resolution of its value and keeps it: at init ConvNeXt's
    # layer scale (1e-6) shrinks its blocks' gradients so, and LayerNorm
    # scales at 1.0 do not change in the warm-up's small steps.  With
    # ``sub_ulp_ok`` such a parameter passes when its last step is shown to
    # be below that resolution (``adam_step_below_resolution``).
    stuck = [n for n, p in unmoved if not (sub_ulp_ok and adam_step_below_resolution(trainer.optimizer, p))]
    if stuck:
        raise AssertionError(f"{name}: parameters {stuck[:4]} did not move")
    sub_ulp = max((float(trainer.optimizer.state[p]["exp_avg"].abs().max()) for _, p in unmoved), default=0.0)
    trainable = sum(p.requires_grad for p in trainer.model.parameters())
    top_grad = max((float(p.grad.norm()), n) for n, p in trainer.model.named_parameters()
                   if p.grad is not None)[1]
    med = statistics.median(times)
    B = len(counts)
    print(f"{name}: {label} bf16 B={B} canvas={tuple(batches[0]['images'].shape[-2:])} "
          f"gts={counts} max_gt={trainer.max_gt}; warmup_s={warmup_s:.2f}; "
          f"launches over {timed} steps={launches}; loss={host['loss']:.4f} "
          f"grad_norm={host['grad_norm']:.4f} (largest in {top_grad}) all {len(host)} metrics finite; "
          f"trainable moved {moved}/{trainable} (all {nonzero} with a clipped gradient above 1e-6), "
          f"frozen unchanged {still}; {len(named)} parameters named {list(must_move)}: moved "
          f"{len(named) - len(unmoved)}, {len(unmoved)} with a nonzero gradient and AdamW steps below half "
          f"their float32 spacing (largest Adam first moment {sub_ulp:.3e}); step_ms={[round(x, 3) for x in times]} median_ms={med:.3f} "
          f"img_s={1000.0 * B / med:.3f} peak_mem_gib={peak_gib:.3f}; card: {smi}")
    return launches


def capture_train_inputs(cfg=None, levels=LEVELS):
    """What one train step at init of ``cfg`` (the flagship by default), as
    the train phase builds it (``Trainer``, B=4, 800x1344, bf16 autocast),
    gives its kernels: value,
    locations, weights and d_out of the first encoder layer (G=1, Q=11403)
    and the first decoder layer (G=8, Q=1100), recorded by a wrapper around
    the MSDA modules' call of ``ms_deform_attn``; and the stacked (7 * B,
    900, 100) costs and valid mask that the criterion hands to
    ``batched_assignment``."""
    cfg = cfg or load_config(DEFAULT_CONFIG)
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
        if c["levels"] != levels or "d_out" not in c:
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
    whose cost rows are exactly N floats long; ``deform_conv_backward`` the
    earlier DCN backward, which adds d_x into a zeroed f32 buffer;
    ``nms_keep_forward`` and ``nms_keep_forward_global`` the keep-mask
    kernel of one block an image, N <= 1024 with the bitmask in shared
    memory and any N with it in a global scratch buffer;
    ``gather_sum_staged`` the cluster-staged gather-sum of
    salience_detr_torch/tools/gather_cluster)."""
    lib = ctypes.CDLL(str(native.build(Path(csrc_dir).resolve())))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    native.bind_msda(lib)
    signatures = {
        "deform_conv_forward": [ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr],
        "deform_conv_fused_forward": [ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr],
        "deform_conv_backward": [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr],
        "deform_conv_backward_halo": [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr],
        "deform_conv_backward_gather": [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr],
        "msda_q8_quantize": [ptr, i32, ptr, ptr, ptr, i64, i32, ptr],
        "msda_q8_sample": [ptr, ptr, native.LevelTable, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr],
        "grid_nms_forward": [ptr, native.LevelTable, ptr, i32, i32, i32, ptr],
        "assignment_forward": [ptr, ptr, ptr, i32, i32, i32, i32, ptr],
        "hungarian_forward": [ptr, ptr, ptr, i32, i32, i32, ptr],
        "nms_keep_forward": [ptr, ctypes.c_float, ptr, i32, i32, ptr],
        "nms_keep_forward_global": [ptr, ctypes.c_float, ptr, ptr, i32, i32, ptr],
        "nms_keep_cluster_forward": [ptr, ctypes.c_float, ptr, ptr, i32, i32, i32, i32, i32, ptr],
        "gather_sum": [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr],
        "gather_sum_staged": [ptr, ptr, ptr] + [i32] * 9 + [ptr],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i32
    if hasattr(lib, "deform_conv_backward_workspace"):
        lib.deform_conv_backward_workspace.argtypes = [i32] * 5
        lib.deform_conv_backward_workspace.restype = i64
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


def in_turns(run, base, new, iters, timer=cuda_ms):
    """Device ms of ``run(lib)`` for base, new, new, base."""
    return [timer(lambda: run(lib), iters) for lib in (base, new, new, base)]


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
    """Whether ``run`` through ``base`` and through ``new`` leaves the same
    values in ``out`` (a tensor or a tuple of them)."""
    outs = out if isinstance(out, tuple) else (out,)
    run(base)
    first = [o.clone() for o in outs]
    run(new)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, outs))


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


def mixed_launcher(cost, valid, copies):
    """A launch-only call of the assignment kernel on the (B, N, M) costs
    with ``copies`` copies of each gt (the wrapper's cap per image), or of
    the plain entry when ``copies`` is 1."""
    B, N, M = cost.shape
    ld = -(-N // 4) * 4
    padded = torch.zeros(B, M, ld, device=cost.device)
    padded[..., :N] = cost.transpose(1, 2)
    flags = valid.to(torch.uint8).contiguous()
    per_image = copy_counts(valid, N, copies)
    out = torch.empty(B, copies * M, dtype=torch.int32, device=cost.device)
    stream, lib = native.stream_of(cost), native.load()

    def run():
        if copies == 1:
            err = lib.assignment_forward(padded.data_ptr(), flags.data_ptr(), out.data_ptr(), B, N, M, ld, stream)
        else:
            err = lib.assignment_copies_forward(padded.data_ptr(), flags.data_ptr(), per_image.data_ptr(),
                                                out.data_ptr(), B, N, M, copies, ld, stream)
        native.check(err, "assignment kernel")

    return run


def mixed_sets_and_totals(cost, match, valid):
    """({(image, gt): sorted queries of its valid copies}, per-image totals in
    float64) on the host; every valid copy holds a distinct query."""
    cost, match, valid = cost.double().cpu(), match.long().cpu(), valid.cpu()
    sets, totals = {}, []
    for b in range(cost.shape[0]):
        used = match[b][valid[b]]
        if len(set(used.tolist())) != len(used) or bool((used < 0).any()) or bool((match[b][~valid[b]] != -1).any()):
            raise AssertionError(f"mixed assignment of image {b} is not a matching of its valid copies")
        gts = torch.nonzero(valid[b])[:, 1]
        totals.append(float(cost[b, used, gts].sum()))
        for g in range(cost.shape[2]):
            sets[(b, g)] = sorted(match[b, valid[b, :, g], g].tolist())
    return sets, totals


def phase_mixed_assignment(smi, assignment):
    """The mixed (Align-DETR) assignment on K4: on the stacked (7 x 4, 900,
    100) costs a flagship train step at init hands the criterion, the kernel
    at C = 2 and C = 10 (C * M = 1000 > N) in one launch against the plain
    version over the tiled columns (the same queries for each gt, equal
    totals; which copy of a gt takes which query is a tie), with the
    wrapper's and the launch-only times beside the plain entry's (C = 1),
    bounds and the plain time; then the flagship trained (phase train, one
    warm-up and one counted step) with ``SetCriterion(mixed_match_copies=2)``
    built directly: one assignment launch a step, every trainable parameter
    with a gradient moved.  Returns (per-C facts, the train steps'
    launches)."""
    t0 = time.perf_counter()
    cost, valid = assignment
    n_img, N, M = cost.shape
    n_valid = int(valid.sum())
    launch_only = {1: queued_ms(mixed_launcher(cost, valid, 1), 20)}
    for C in (2, 10):
        before = native.LAUNCHES["hungarian"]
        got, got_valid = batched_mixed_assignment(cost, valid, C)
        torch.cuda.synchronize()
        if native.LAUNCHES["hungarian"] != before + 1:
            raise AssertionError(f"mixed assignment C={C}: {native.LAUNCHES['hungarian'] - before} launches")
        t_plain = time.perf_counter()
        want, want_valid = batched_mixed_assignment_plain(cost, valid, C)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t_plain)
        got_sets, got_totals = mixed_sets_and_totals(cost, got, got_valid)
        want_sets, want_totals = mixed_sets_and_totals(cost, want, want_valid)
        if not torch.equal(got_valid, want_valid) or got_sets != want_sets or got_totals != want_totals:
            differ = sum(got_sets[k] != want_sets[k] for k in got_sets)
            raise AssertionError(f"mixed assignment C={C}: copy validity equal {torch.equal(got_valid, want_valid)}, "
                                 f"{differ} gts with other queries, totals {got_totals} vs {want_totals}")
        ms = cuda_ms(lambda: batched_mixed_assignment(cost, valid, C), 10)
        launch_only[C] = queued_ms(mixed_launcher(cost, valid, C), 20)
        rows = got_valid.flatten(1).sum(1)
        # reads the valid gts' costs once (the copies read the same rows),
        # the mask and the copy counts, writes one query per copy slot; at
        # least one comparison per row and query
        t = (ms, plain_ms, *bound(n_valid * N * 4 + nbytes(valid, got) + 4 * n_img, int(rows.sum()) * N))
        print(f"mixed_assignment: C={C} on the captured train step's {n_img // 4} sets x B=4, N={N} M={M} "
              f"valid={GT_COUNTS}: rows per image (copies x valid gts) {rows[:4].tolist()} (C*M={C * M}); "
              f"kernel vs plain: same copy validity, same queries for all {len(got_sets)} (image, gt), totals "
              f"equal ({[round(x, 4) for x in got_totals[:4]]} ...); one launch kernel_ms={ms:.4f} "
              f"launch_only_ms={launch_only[C]:.4f} (C=1 {launch_only[1]:.4f}) plain_ms={plain_ms:.1f} "
              f"bound_ms={t[2]:.6f} ({t[3]}); card: {smi}")
    cfg = load_config(DEFAULT_CONFIG)
    mixed = criterion_module.SetCriterion(
        cfg.num_classes, cfg.cost_class, cfg.cost_bbox, cfg.cost_giou, cfg.focal_alpha, cfg.focal_gamma,
        hybrid=True, mixed_match_copies=2,
    )
    launches = phase_train(smi, name="train_mixed", timed=1, criterion=mixed)
    print(f"mixed_assignment: phase_s={time.perf_counter() - t0:.2f}")
    return launches


def phase_msda_stages(smi, baselines=()):
    """The shootout's entry point at the hot layer, counted; then K5-K8
    against their plain versions and the pipelines against K1 (uncounted);
    with ``--baseline-csrc``, the ``gather_ab:`` lines (:func:`gather_ab`)."""
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
    if baselines:
        gather_ab(smi, baselines, B, Q)
    return launches, results


# staging variants of the cluster-staged gather-sum at the hot shape (S =
# 22,323 over LEVELS: level sizes 16,800, 4,200, 1,050, 273): (T, cluster,
# qsplit); levels 2-3 in one block (85 KB), one block's whole 227 KB (two
# waves), levels 1-3 over 2 and 4 blocks, 4 blocks' whole budget, the whole
# slice over 8 blocks; qsplit puts 128 or 256 blocks on the 132 SMs
GATHER_VARIANTS = [(0, 1, 8), (1323, 1, 4), (1323, 1, 8), (3584, 1, 8), (5523, 2, 2), (5523, 4, 1),
                   (14336, 4, 1), (22323, 8, 1)]


def level_shaped_indices(locs, levels=LEVELS, H=8):
    """(B, H, Q, 64) int32 gather indices from the shootout's locations: the
    bilinear corners of each (level, point), shared by the H heads, so that
    each level takes a quarter of the rows read (three quarters fall in the
    4,200 + 1,050 + 273 rows of levels 1-3)."""
    idx, _ = stages.corners_flat(locs, levels)  # (B, Q, 4L, P)
    B, Q = idx.shape[:2]
    return idx.reshape(B, Q, -1)[:, None].expand(B, H, Q, idx.shape[2] * idx.shape[3]).contiguous()


def gather_ab(smi, baselines, B, Q):
    """K5 at the hot shape on the shootout's uniform indices and on
    level-shaped ones: each directory's gather-sum timed in turns with the
    shipped one (base, new, new, base; launch only), its output held bitwise
    equal, with both shares of the bound and the row bytes each reads from
    L2 (rows not staged in shared memory).  A directory with the
    cluster-staged kernel (``gather_sum_staged``, salience_detr_torch/tools/
    gather_cluster) is timed at each of ``GATHER_VARIANTS``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    value, idx_uniform = stage_tool.gather_inputs(Q, LEVELS, gen, dev)
    idx_uniform = idx_uniform.permute(0, 2, 1, 3).contiguous()
    _, locs, _ = stages.make_inputs(Q, LEVELS, B, generator=gen, device=dev)
    Bv, S, H, D = value.shape
    new = native.load()
    bases = [(d, baseline_library(d)) for d in baselines]
    for label, idx in (("uniform", idx_uniform), ("level-shaped", level_shaped_indices(locs, H=H))):
        G = idx.shape[-1]
        stream = native.stream_of(value)
        want = stages.gather_sum(value, idx)
        bound_ms, bound_by = bound(nbytes(value, idx, want), idx.numel() * D)
        valid = (idx >= 0) & (idx < S)
        outs = {}

        def run(lib, variant=None):
            out = outs.setdefault(id(lib), torch.empty_like(want))
            if hasattr(lib, "gather_sum"):
                err = lib.gather_sum(value.data_ptr(), idx.data_ptr(), out.data_ptr(), Bv, S, H, D, Q, G, stream)
            else:
                err = lib.gather_sum_staged(value.data_ptr(), idx.data_ptr(), out.data_ptr(), Bv, S, H, D, Q, G,
                                            *variant, stream)
            native.check(err, "gather_sum")

        for base_dir, base in bases:
            if not (hasattr(base, "gather_sum") or hasattr(base, "gather_sum_staged")):
                continue
            staged = not hasattr(base, "gather_sum")
            for variant in (GATHER_VARIANTS if staged else [None]):
                outs.clear()
                times = in_turns(lambda lib: run(lib, variant), base, new, 10)
                torch.cuda.synchronize()
                if not torch.equal(outs[id(base)], outs[id(new)]) or not torch.equal(outs[id(new)], want):
                    raise AssertionError(f"gather_ab: {base_dir} {variant} differs from the shipped K5 on {label}")
                base_ms, new_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
                l2_base = int((valid & (idx < S - variant[0])).sum()) * 64 if staged else int(valid.sum()) * 64
                desc = f"T={variant[0]} cluster={variant[1]} qsplit={variant[2]}" if staged else "one warp a query"
                print(f"gather_ab: {label} B={Bv} H={H} Q={Q} G={G} baseline={base_dir} ({desc}): K5 ms "
                      f"base/new/new/base {[round(x, 4) for x in times]} (launch only), outputs bitwise equal; "
                      f"bound_ms={bound_ms:.4f} ({bound_by}) share base {bound_ms / base_ms:.1%} new "
                      f"{bound_ms / new_ms:.1%}; L2 row bytes base {l2_base} new {int(valid.sum()) * 64}; "
                      f"card: {smi}")


def stage_checks(dev, B, Q):
    """K5-K8 against their plain versions (times beside) and the pipelines
    against K1, on the shootout's inputs over LEVELS.  Returns the report's
    parts and, per kernel, (largest error, (ms, plain ms) of its first case)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    value, locs, w = stages.make_inputs(Q, LEVELS, B, generator=gen, device=dev)
    C = value.shape[-1]
    results, parts = {}, []

    def kernel_vs_plain(key, label, fn, plain, dtype, inputs=(), ops=0, library=None, note=""):
        """``inputs`` and ``ops``: what the kernel reads and computes (its
        output is added to the bytes); ``library``: one PyTorch call of the
        same function, timed as a yardstick; ``note``: printed after the
        bound."""
        got, want = fn(), plain()
        torch.cuda.synchronize()
        max_abs, _, bad, atol, rtol = compare(got, want, dtype)
        bound_ms, bound_by = bound(nbytes(*inputs, got), ops)
        del got, want
        ms, plain_ms = cuda_ms(fn, 10), cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 10) if library is not None else None
        parts.append(f"{label} max_abs_err={max_abs:.3e} (atol {atol} rtol {rtol}, violations {bad}) "
                     f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}){note}"
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
                    lambda: torch.nn.functional.embedding_bag(bags, table, mode="sum"),
                    # every row in range is read from L2 (none is staged)
                    f" l2_row_bytes={int(((gidx >= 0) & (gidx < Sg)).sum()) * 64}")
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


def capture_post_boxes():
    """The (B, 300, 4) scaled top-k boxes of a flagship serve forward's
    post-process (B=4, the TIMED_BATCH canvas, random weights from seed 0):
    what its NMS filter hands to ``nms_keep_mask``."""
    cfg = load_config(DEFAULT_CONFIG)
    predictor = Predictor(cfg, None, "cuda", seed=0)
    return predictor.forward(*preprocess(make_requests(TIMED_BATCH, 7), cfg, "cuda"))["boxes"].contiguous()


def greedy_iou_tests(boxes, keep, thr):
    """The IoU tests the greedy rule needs on these boxes: for each kept box,
    one with every later box that no better-ranked kept box suppressed."""
    N = boxes.shape[1]
    iou, _ = box_iou_pairwise(boxes, boxes)
    rank = torch.arange(N, device=boxes.device)
    later = rank[:, None] < rank[None, :]  # (i, j): i ranked before j
    suppress = (iou > float(np.float32(thr))) & later & keep[:, :, None]
    first = torch.where(suppress.any(1), suppress.float().argmax(1), N)  # (B, N) first kept suppressor
    return int((keep[:, :, None] & later & (first[:, None, :] >= rank[None, :, None])).sum())


def keep_launcher(boxes, thr):
    """A launch-only call of a library's keep-mask kernel on these boxes
    (output and scratch allocated once): the cluster kernel, by default at
    the wrapper's placement of the rows, where the library has it; else the
    one-block-an-image kernel (its shared-memory variant up to 1024 boxes,
    its global-memory one past)."""
    B, N, _ = boxes.shape
    keep = torch.empty(B, N, dtype=torch.bool, device=boxes.device)
    scratch = torch.empty(B, N, -(-N // 32), dtype=torch.int32, device=boxes.device)
    stream, thr32 = native.stream_of(boxes), float(np.float32(thr))
    planned = nms_keep_plan(N)

    def run(lib, rows=planned[0], cluster=planned[1], fill_only=0):
        if hasattr(lib, "nms_keep_cluster_forward"):
            err = lib.nms_keep_cluster_forward(boxes.data_ptr(), thr32, keep.data_ptr(), scratch.data_ptr(), B, N,
                                               NMS_KEEP_ROWS[rows], cluster, fill_only, stream)
        elif N <= 1024:
            err = lib.nms_keep_forward(boxes.data_ptr(), thr32, keep.data_ptr(), B, N, stream)
        else:
            err = lib.nms_keep_forward_global(boxes.data_ptr(), thr32, keep.data_ptr(), scratch.data_ptr(), B, N,
                                              stream)
        native.check(err, "nms_keep")

    return run, keep


def keep_variants(N):
    """(rows, cluster) placements of the cluster kernel worth timing at N:
    clusters of 8 and of 16 blocks (each at most one a window), the rows in
    the walking block where they fit it, in the filling blocks where they
    fit those, in global memory always."""
    out = []
    for cluster in (8, 16):
        C = max(1, min(cluster, -(-N // 32)))
        for rows in ("local", "remote", "global"):
            if (rows, C) not in out and (rows == "global" or nms_keep_smem_bytes(rows, N, C) <= SMEM_OPTIN_BYTES):
                out.append((rows, C))
    return out


def phase_nms_keep(smi, baselines):
    """K9 against its plain version, exactly, on a flagship serve forward's
    post-process boxes (thresholds 0.5 and 0.7), on a chain of boxes each
    overlapping only its neighbours (IoU 0.6, 1/3 two apart) and on identical
    boxes; then on random boxes at N = 300, 600, 1024, 1400 and 4096, with
    device times of the launch alone (queued behind a sleeping kernel, so
    that the host's enqueue rate does not show), of the fill alone (the
    kernel stopped after it; the walk is the rest), of the wrapper, and of
    every placement of the rows at clusters of 8 and 16 blocks
    (``nms_keep_variants:``, each held exactly).  With ``--baseline-csrc``,
    each directory's keep-mask kernel is timed in turns with this one on
    every case (``keep_ab:``)."""
    dev = torch.device("cuda")
    boxes = capture_post_boxes()
    B, N, _ = boxes.shape
    x = torch.arange(N, device=dev, dtype=torch.float32) * 2.5
    chain = torch.stack([x, torch.zeros_like(x), x + 10, torch.full_like(x, 10)], -1).expand(B, N, 4).contiguous()
    identical = torch.tensor([3.0, 4.0, 50.0, 60.0], device=dev).expand(B, N, 4).contiguous()
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = [("captured serve", boxes, 0.5), ("captured serve", boxes, 0.7), ("chain", chain, 0.5),
             ("identical", identical, 0.7)]
    for n in (300, 600, 1024, 1400, 4096):
        xy = torch.rand(B, n, 2, generator=gen, device=dev) * 400
        cases.append((f"random N={n}", torch.cat([xy, xy + 5 + torch.rand(B, n, 2, generator=gen, device=dev) * 60],
                                                 -1), 0.5))
    timing, new = None, native.load()
    bases = [(d, baseline_library(d)) for d in baselines]
    for name, bx, thr in cases:
        got, want = nms_keep_mask(bx, thr), nms_keep_mask_plain(bx, thr)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        if mismatches:
            raise AssertionError(f"nms_keep kernel differs from plain in {mismatches} entries on {name} at {thr}")
        n = bx.shape[1]
        run, keep = keep_launcher(bx, thr)
        ms = queued_ms(lambda: run(new), 100)  # the launch alone
        fill_ms = queued_ms(lambda: run(new, fill_only=1), 100)
        wrapper_ms = cuda_ms(lambda: nms_keep_mask(bx, thr), 20)
        plain_ms = cuda_ms(lambda: nms_keep_mask_plain(bx, thr), 3)
        tests = greedy_iou_tests(bx, got, thr)
        # reads the boxes, writes the mask; IOU_OPS per needed IoU test
        t = (ms, plain_ms, *bound(nbytes(bx, got), tests * IOU_OPS))
        rows, C = nms_keep_plan(n)
        print(f"nms_keep: {name} B={bx.shape[0]} N={n} thr={thr} kept={got.sum(1).tolist()} "
              f"mismatches={mismatches} rows={rows} cluster={C} kernel_ms={ms:.4f} (launch only) "
              f"fill_ms={fill_ms:.4f} walk_ms={ms - fill_ms:.4f} wrapper_ms={wrapper_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={t[2]:.6f} ({t[3]}) iou_tests={tests} "
              f"kernel_us_per_rank={1000 * ms / n:.4f}; card: {smi}")
        if (name, thr) == ("captured serve", 0.7):  # the eval phase's filter
            timing = t
        if name.startswith(("captured", "random")) and thr == 0.5:
            parts = []
            for rows_v, C_v in keep_variants(n):
                keep.zero_()
                run(new, rows_v, C_v)
                torch.cuda.synchronize()
                bad = int((keep != want).sum())
                if bad:
                    raise AssertionError(f"nms_keep {rows_v} cluster {C_v} differs from plain in {bad} entries "
                                         f"on {name}")
                v_ms = queued_ms(lambda: run(new, rows_v, C_v), 100)
                v_fill = queued_ms(lambda: run(new, rows_v, C_v, 1), 100)
                parts.append(f"{rows_v}/C{C_v} {v_ms:.4f} (fill {v_fill:.4f}, walk {v_ms - v_fill:.4f})")
            print(f"nms_keep_variants: {name} N={n} thr={thr} launch-only ms: {'; '.join(parts)}; mismatches 0; "
                  f"card: {smi}")
        for base_dir, base in bases:
            if hasattr(base, "nms_keep_forward") and (n <= 1024 or hasattr(base, "nms_keep_forward_global")):
                print(f"keep_ab: {name} N={n} thr={thr} baseline={base_dir}: K9 ms base/new/new/base "
                      f"{[round(x, 4) for x in in_turns(run, base, new, 100, queued_ms)]} (launch only, "
                      f"bound {t[2]:.6f}); card: {smi}")
    return timing


def write_eval_split(root, seed=12):
    """EVAL_SIZES as ``.npy`` uint8 RGB images drawn from ``seed`` (the card's
    machine has no cv2) and a COCO annotation file with 5 random boxes per
    image, the last a crowd box, labels in 1..90; returns (image dir,
    annotation path)."""
    rng = np.random.default_rng(seed)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(EVAL_SIZES):
        np.save(img_dir / f"{i:03d}.npy", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        images.append({"id": i + 1, "file_name": f"{i:03d}.npy", "height": h, "width": w})
        for k in range(5):
            bw, bh = rng.uniform(0.05, 0.5) * w, rng.uniform(0.05, 0.5) * h
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": int(rng.integers(1, 91)),
                         "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": int(k == 4)})
    ann = root / "annotations.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": c, "name": f"class{c}"} for c in range(91)]}))
    return img_dir, ann


def check_stats(stats, label):
    if list(stats) != METRIC_NAMES or not all(np.isfinite(v) for v in stats.values()):
        raise AssertionError(f"{label}: stats {stats}")


def phase_eval(smi):
    """The evaluation path on a COCO-format split of EVAL_SIZES written under
    build/: run 1 builds the flagship in exact mode (``exact_sampling``),
    loads a seed-initialised exact-mode state dict strictly and runs the
    entry point's functions (``make_eval_step`` with ``PostProcess(0.7 NMS,
    0.05 confidence)``, ``evaluate`` over ``DetectionLoader`` and
    ``DevicePrefetcher``) at B=4; run 2 calls the entry point's ``main`` on
    the hybrid flagship, filters off, with --save-results (its wall time
    includes building the model), then re-scores the file with
    --result-file.  Launches per forward must be 12 MSDA, 1
    grid NMS and 1 (run 1) or 0 (run 2) NMS keep mask.  K1 is held against
    its plain version on run 1's first encoder layer (G=8, Q=11403)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    img_dir, ann = write_eval_split(EVAL_DIR)
    flagship = load_config(DEFAULT_CONFIG)
    exact = exact_sampling(flagship)
    ckpt = EVAL_DIR / "exact_flagship_seed1.pth"
    model, _ = build_salience_detr(exact, dev, torch.Generator().manual_seed(1))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    del model
    dataset = CocoDetection(str(img_dir), str(ann))
    forwards = sum(1 for _ in DetectionLoader(dataset, 4))
    layers = flagship.num_encoder_layers + flagship.num_decoder_layers
    expect = {k: 0 for k in native.LAUNCHES}

    model, _ = build_salience_detr(exact, dev, torch.Generator().manual_seed(2))
    model.load_state_dict(eval_entry.load_state_dict(str(ckpt)), strict=True)
    post = PostProcess(exact.select_box_nums_for_evaluation, nms_iou_threshold=0.7, confidence_score=0.05)
    evaluator = CocoEvaluator(dataset.coco)
    captured, real = {}, attention.ms_deform_attn

    def recording(value, spatial_shapes, locations, weights):
        if not captured:  # the first batch's first encoder layer
            captured.update(value=value, locations=locations, weights=weights,
                            levels=[tuple(x) for x in spatial_shapes])
        return real(value, spatial_shapes, locations, weights)

    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
    attention.ms_deform_attn = recording
    try:
        t1 = time.perf_counter()
        stats1 = evaluate(make_eval_step(model, post, exact.dtype),
                          DevicePrefetcher(DetectionLoader(dataset, 4), functools.partial(to_device, cfg=exact), dev), evaluator)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t1
    finally:
        attention.ms_deform_attn = real
    launches1 = dict(native.LAUNCHES)
    if launches1 != {**expect, "msda": layers * forwards, "grid_nms": forwards, "nms_keep": forwards}:
        raise AssertionError(f"eval run 1: launch counts {launches1} for {forwards} forwards")
    check_stats(stats1, "eval run 1")
    kept = sum(len(p["scores"]) for p in evaluator.predictions.values())
    t3 = time.perf_counter()  # the host's share of the wall time: the COCO protocol again
    evaluator.accumulate()
    evaluator.summarize()
    accumulate_s = time.perf_counter() - t3
    del model

    value, locs, weights, levels = (captured[k] for k in ("value", "locations", "weights", "levels"))
    Bk, Q, G = locs.shape[:3]
    if (G, Q, levels) != (exact.num_heads, 11403, LEVELS):
        raise AssertionError(f"captured exact-mode encoder layer: G={G} Q={Q} levels {levels}")
    got, want = ms_deform_attn(value, levels, locs, weights), ms_deform_attn_plain(value, levels, locs, weights)
    torch.cuda.synchronize()
    max_abs, _, bad, atol, rtol = compare(got, want, value.dtype)
    if bad:
        raise AssertionError(f"msda kernel disagrees with plain on the exact-mode encoder inputs: {bad} elements")
    k1_ms = cuda_ms(lambda: ms_deform_attn(value, levels, locs, weights), 20)
    k1_plain = cuda_ms(lambda: ms_deform_attn_plain(value, levels, locs, weights), 5)
    (fb, fby), _ = msda_bounds(value, locs, weights)
    del captured, value, locs, weights, got, want

    pred = EVAL_DIR / "predictions.json"
    split = ["--coco-img", str(img_dir), "--coco-ann", str(ann)]
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
    t2 = time.perf_counter()
    stats2 = eval_entry.main(split + ["--batch-size", "4", "--seed", "0", "--save-results", str(pred)])
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t2
    launches2 = dict(native.LAUNCHES)
    if launches2 != {**expect, "msda": layers * forwards, "grid_nms": forwards}:
        raise AssertionError(f"eval run 2: launch counts {launches2} for {forwards} forwards")
    check_stats(stats2, "eval run 2")
    rescored = eval_entry.main(split + ["--result-file", str(pred)])
    gap = max(abs(rescored[k] - v) for k, v in stats2.items())
    if gap > 1e-12:
        raise AssertionError(f"re-scored stats {rescored} differ from the eval's {stats2}")
    n = len(dataset)
    print(f"eval: {n} .npy images {EVAL_SIZES} in {forwards} forwards of B<=4, box matching route "
          f"{evaluator.route}; run 1 exact mode (G=8 encoder and decoder), strict load of {ckpt.name}, "
          f"PostProcess(nms 0.7, confidence 0.05): launches={launches1}, valid detections={kept}, "
          f"stats={ {k: round(v, 6) for k, v in stats1.items()} }, wall_s={wall1:.3f} img_s={n / wall1:.3f} "
          f"(of which accumulate and summarize {accumulate_s:.3f} s, timed again); "
          f"K1 on the first exact-mode encoder layer G={G} B={Bk} "
          f"Q={Q} max_abs_err={max_abs:.3e} (atol {atol} rtol {rtol}) kernel_ms={k1_ms:.4f} plain_ms={k1_plain:.4f} "
          f"bound_ms={fb:.4f} ({fby}); run 2 hybrid flagship through salience_detr_torch.test.main, filters off: "
          f"launches={launches2}, stats={ {k: round(v, 6) for k, v in stats2.items()} }, wall_s={wall2:.3f} "
          f"img_s={n / wall2:.3f}, re-scored from {pred.name} max gap {gap:.3e}; "
          f"phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return launches1


# the train_coco phase's split: COCO's three most common image sizes, half
# portrait (20 images give at least 4 batches of 4 an epoch whatever the
# crops do to the orientations), 0 to 40 boxes per image (about one in eight
# a crowd box), written under an ignored directory of the checkout
TRAIN_COCO_SIZES = [(480, 640), (640, 480), (427, 640), (640, 480)] * 5
TRAIN_COCO_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
TRAIN_STEP_KERNELS = {"msda": 12, "msda_backward": 12, "grid_nms": 1, "hungarian": 1}  # per micro-batch
EVAL_FORWARD_KERNELS = {"msda": 12, "grid_nms": 1}
# fp16 epochs of the train_coco phase: at init the float16 gradient of
# transformer.enc_output.bias (a sum over B x 22323 tokens) is not finite at a
# loss scale of 16 on padded images (tools/fp16_grad_probe.py), so the
# GradScaler, from its default 65536, skips its first steps (17 on this
# phase's data) before it steps
FP16_EPOCHS = 5
STRONG_STEPS = 3  # the train_coco_strong phase's steps


def write_train_split(root, seed=21, polygons=False):
    """TRAIN_COCO_SIZES as ``.npy`` uint8 RGB images drawn from ``seed`` and a
    COCO annotation file with 0 to 40 random boxes per image, labels in
    1..90; with ``polygons`` each annotation also has a segmentation of one
    or two polygons of 3 to 16 random vertices around its box (some past the
    image, many self-intersecting), drawn after all the boxes; returns
    (image dir, annotation path)."""
    rng = np.random.default_rng(seed)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(TRAIN_COCO_SIZES):
        np.save(img_dir / f"{i:03d}.npy", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        images.append({"id": i + 1, "file_name": f"{i:03d}.npy", "height": h, "width": w})
        for _ in range(int(rng.integers(0, 41))):
            bw, bh = rng.uniform(0.02, 0.5) * w, rng.uniform(0.02, 0.5) * h
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": int(rng.integers(1, 91)),
                         "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": int(rng.uniform() < 0.125)})
    if polygons:
        for a in anns:
            x, y, bw, bh = a["bbox"]
            a["segmentation"] = [
                np.stack([rng.uniform(x - 0.1 * bw, x + 1.1 * bw, k), rng.uniform(y - 0.1 * bh, y + 1.1 * bh, k)],
                         1).reshape(-1).round(2).tolist()
                for k in rng.integers(3, 17, int(rng.integers(1, 3)))
            ]
    ann = root / "annotations.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": c, "name": f"class{c}"} for c in range(1, 91)]}))
    return img_dir, ann


class TimedStep(train_step_module.TrainStep):
    """The CLI's train step, timed (host clock to a synchronise, and CUDA
    events) with the kernel launches, canvas and gt counts of each step;
    ``last`` is the last instance built, which keeps its batches for a
    replay."""

    records: list = []
    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batches = []
        TimedStep.last = self

    def __call__(self, batch, generator=None, draws=None):
        self.batches.append(batch)
        before = dict(native.LAUNCHES)
        scale = self.scaler.get_scale() if self.scaler is not None else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = super().__call__(batch, generator, draws)
        end.record()
        torch.cuda.synchronize()
        TimedStep.records.append({
            "wall_ms": 1e3 * (time.perf_counter() - t0), "device_ms": start.elapsed_time(end),
            "launches": {k: native.LAUNCHES[k] - before[k] for k in native.LAUNCHES},
            "canvas": tuple(batch["images"].shape[-2:]), "counts": batch["targets"].counts,
            "accumulate": self.accumulate_steps,
            "losses_finite": all(bool(torch.isfinite(v)) for k, v in metrics.items() if k != "grad_norm"),
            "grad_norm": float(metrics["grad_norm"]),
            # a GradScaler skips a step whose gradients overflowed and halves its scale
            "stepped": scale is None or self.scaler.get_scale() >= scale,
            "scale": self.scaler.get_scale() if self.scaler is not None else None,
        })
        return metrics


def train_coco_config(path, img_dir, ann, output_dir, **overrides):
    values = dict(
        num_epochs=1, batch_size=4, num_workers=8, print_freq=1, output_dir=str(output_dir), train_transform="detr",
        train_img_folder=str(img_dir), train_ann_file=str(ann), test_img_folder=str(img_dir), test_ann_file=str(ann),
        model_path=str(DEFAULT_CONFIG), resume_from_checkpoint=True, learning_rate=1e-4, train_canvas=(800, 1344),
        max_gt=100,
    )
    values.update(overrides)
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in values.items()))
    return str(path)


def run_train_cli(args, forwards):
    """``salience_detr_torch.train.main(args)`` with the launch counts set to
    0 just before and read just after; checks that each train step launched
    K1, K3 (the ordered design with --use-deterministic-algorithms, which is
    switched off again after the run), K2 and K4 as the flagship's
    micro-batches need and each eval forward (``forwards`` after each epoch)
    K1 and K2; returns (summary, this run's step records, launches)."""
    first = len(TimedStep.records)
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
    try:
        summary = train_entry.main(args)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    records = TimedStep.records[first:]
    step_kernels = dict(TRAIN_STEP_KERNELS)
    if "--use-deterministic-algorithms" in args:
        step_kernels["msda_backward_ordered"] = step_kernels.pop("msda_backward")
    for r in records:
        want = {k: v * r["accumulate"] for k, v in step_kernels.items()}
        finite = r["losses_finite"] and (not r["stepped"] or np.isfinite(r["grad_norm"]))
        if {k: r["launches"][k] for k in want} != want or not finite:
            raise AssertionError(f"train_coco step {r}")
    evals = 0 if summary["stats"] is None else forwards * len(summary["epochs"])  # an eval after each epoch
    expect = {k: sum(r["launches"][k] for r in records) for k in launches}
    for k, v in EVAL_FORWARD_KERNELS.items():
        expect[k] += v * evals
    if launches != expect:
        raise AssertionError(f"train_coco: launches {launches}, expected {expect} ({len(records)} steps, {evals} "
                             "eval forwards)")
    if not all(np.isfinite(v) for k, v in summary["metrics"].items() if k != "grad_norm"):
        raise AssertionError(f"train_coco: non-finite losses {summary['metrics']}")
    if summary["stats"] is not None:
        check_stats(summary["stats"], "train_coco eval")
    return summary, records, launches


def phase_train_coco(smi):
    """The train CLI (python -m salience_detr_torch.train) on a COCO-format
    split of TRAIN_COCO_SIZES written under build/: the flagship at full
    width, bf16, B=4, the detr preset, the fixed canvases of both
    orientations; run 1 trains 4 steps of epoch 0, evaluates and
    checkpoints; run 2 resumes from that checkpoint at epoch 1 for 2 steps
    and evaluates; run 3 trains 1 step at --accumulate-steps 2 (two
    micro-batches of 2) with --use-deterministic-algorithms (the ordered
    K3); run 4 trains FP16_EPOCHS epochs in fp16 with the
    GradScaler, evaluating after each, whose losses must be finite and which
    must take at least one step (it skips a step whose scaled gradients
    overflowed and halves its scale).
    Each step must launch K1 and K3 12 times, K2 and K4 once per
    micro-batch, each eval forward K1 12 times and K2 once.  Returns run 1's
    launches over its 4 steps, run 3's and the host transform ms a
    sample."""
    import shutil

    t0 = time.perf_counter()
    if TRAIN_COCO_DIR.exists():
        shutil.rmtree(TRAIN_COCO_DIR)
    img_dir, ann = write_train_split(TRAIN_COCO_DIR)
    forwards = sum(1 for _ in DetectionLoader(CocoDetection(str(img_dir), str(ann)), 4))
    real_make = train_entry.make_train_step
    train_entry.make_train_step = lambda *a, **k: TimedStep(*a, **k)
    out = TRAIN_COCO_DIR / "run"
    try:
        config = train_coco_config(TRAIN_COCO_DIR / "epoch0.py", img_dir, ann, out)
        torch.cuda.reset_peak_memory_stats()
        s1, r1, l1 = run_train_cli(["--config-file", config, "--seed", "0", "--dry-run-steps", "4"], forwards)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        # run 1's step on its own device batches again, no loader thread running
        replay = TimedStep.last
        generator = torch.Generator(replay.batches[0]["images"].device).manual_seed(0)
        for batch in replay.batches[:] * 2:
            replay(batch, generator)
        replay_ms = [r["wall_ms"] for r in TimedStep.records[-len(r1):]]
        replay.batches.clear()
        TimedStep.last = replay = None  # run 1's model and optimizer go
        restored = CheckpointManager(str(out / "checkpoints")).restore()
        model, _ = build_salience_detr(load_config(DEFAULT_CONFIG), torch.device("cuda"))
        model.load_state_dict(restored["model"], strict=True)  # the checkpoint is a whole state dict
        del model
        config = train_coco_config(TRAIN_COCO_DIR / "epoch1.py", img_dir, ann, out, num_epochs=2)
        s2, r2, _ = run_train_cli(["--config-file", config, "--dry-run-steps", "2"], forwards)
        config = train_coco_config(TRAIN_COCO_DIR / "accum.py", img_dir, ann, TRAIN_COCO_DIR / "accum")
        s3, r3, l3 = run_train_cli(["--config-file", config, "--seed", "1", "--dry-run-steps", "1",
                                    "--accumulate-steps", "2", "--use-deterministic-algorithms"], forwards)
        config = train_coco_config(TRAIN_COCO_DIR / "fp16.py", img_dir, ann, TRAIN_COCO_DIR / "fp16",
                                   num_epochs=FP16_EPOCHS)
        s4, r4, _ = run_train_cli(["--config-file", config, "--seed", "2", "--mixed-precision", "fp16"], forwards)
        scaler = CheckpointManager(str(TRAIN_COCO_DIR / "fp16" / "checkpoints")).restore()["scaler"]
    finally:
        train_entry.make_train_step = real_make
    if ((len(r1), len(r2), len(r3)) != (4, 2, 1) or len(r4) < 4 * FP16_EPOCHS
            or s4["epochs"] != list(range(FP16_EPOCHS))):
        raise AssertionError(f"train_coco: steps {len(r1)}, {len(r2)}, {len(r3)}, {len(r4)}")
    if (s2["starting_epoch"], restored["step"], s2["global_step"]) != (1, 4, 6) or s2["seed"] != 0:
        raise AssertionError(f"train_coco: resumed at epoch {s2['starting_epoch']} from step {restored['step']} "
                             f"to step {s2['global_step']}, seed {s2['seed']}")
    records = r1 + r2 + r3
    canvases = sorted({r["canvas"] for r in records})
    if len(canvases) != 2 or canvases[0] != canvases[1][::-1]:
        raise AssertionError(f"train_coco: canvases {canvases}, both orientations expected")
    fp16_stepped = [r for r in r4 if r["stepped"]]
    if scaler is None or not scaler["scale"] > 0 or not fp16_stepped:
        raise AssertionError(f"train_coco fp16: scaler state {scaler}, steps {r4}")
    counts = [n for r in records for n in r["counts"]]
    wall = [r["wall_ms"] for r in r1 + r2]
    device = [r["device_ms"] for r in r1 + r2]
    warm = [r["wall_ms"] for r in r1[1:] + r2[1:]]  # each run's first step warms up the process
    steps = len(wall)
    waits_ms = [1e3 * w for w in s1["loader_waits_s"][:len(r1)] + s2["loader_waits_s"][:len(r2)]]
    transform_ms = 1e3 * (s1["transform_s"] + s2["transform_s"]) / max(s1["samples"] + s2["samples"], 1)
    per_step = {k: sum(r["launches"][k] for r in r1) / len(r1) for k in TRAIN_STEP_KERNELS}
    print(f"train_coco: flagship R50 bf16 B=4 detr preset through salience_detr_torch.train.main on "
          f"{len(TRAIN_COCO_SIZES)} .npy images {sorted(set(TRAIN_COCO_SIZES))}; run 1 {len(r1)} steps + eval, "
          f"run 2 resumed at epoch {s2['starting_epoch']} from step {restored['step']} for {len(r2)} steps "
          f"(global step {s2['global_step']}) + eval, run 3 --accumulate-steps 2 --use-deterministic-algorithms "
          f"{len(r3)} step, run 4 fp16 "
          f"{FP16_EPOCHS} epochs, {len(r4)} steps, {FP16_EPOCHS} evals (the scaler stepped {len(fp16_stepped)}, "
          f"scales {[r['scale'] for r in r4]}, "
          f"grad_norm {[round(r['grad_norm'], 3) for r in r4]}); canvases {canvases}; "
          f"gts per image min {min(counts)} max {max(counts)} zero-gt images {counts.count(0)}; "
          f"step wall_ms={[round(x, 3) for x in wall]} median_wall_ms (runs 1-2 but their first steps)="
          f"{statistics.median(warm):.3f} device_ms={[round(x, 3) for x in device]}; run 1's steps again on its "
          f"batches with no loader running: wall_ms={[round(x, 3) for x in replay_ms]} median="
          f"{statistics.median(replay_ms):.3f}; loader_wait_ms per step={[round(x, 3) for x in waits_ms]} "
          f"mean={statistics.mean(waits_ms):.3f} host_transform_ms_per_sample={transform_ms:.3f} "
          f"(8 worker threads, 1 intra-op thread each); run 1 launches per step {per_step} and in all "
          f"{ {k: v for k, v in l1.items() if v} } with {forwards} eval forwards; accumulated step launches "
          f"{ {k: v for k, v in r3[0]['launches'].items() if v} }; "
          f"peak_mem_gib={peak_gib:.3f}; run 1 loss={s1['metrics']['loss']:.4f} grad_norm="
          f"{s1['metrics']['grad_norm']:.4f} eval AP={s1['stats']['AP']:.6f} AR100={s1['stats']['AR100']:.6f}, "
          f"run 2 loss={s2['metrics']['loss']:.4f}, run 3 loss={s3['metrics']['loss']:.4f}, run 4 loss="
          f"{s4['metrics']['loss']:.4f}, all finite; phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return {k: sum(r["launches"][k] for r in r1) for k in native.LAUNCHES}, l3, transform_ms


def phase_train_coco_strong(smi, detr_transform_ms):
    """The train CLI as in phase train_coco's run 1, with the options that
    need OpenCV in the JAX package: the ``strong_album`` preset and
    ``copypaste`` (the dataset loads each annotation's polygons as a mask,
    the loader composites each batch), on a TRAIN_COCO_SIZES split with
    polygon segmentations written under build/, with ``cv2`` blocked from
    import: the flagship at full width, bf16, B=4, both canvases,
    STRONG_STEPS steps of epoch 0 and its eval.  Each step must launch K1
    and K3 12 times, K2 and K4 once, the losses must be finite.  Prints the
    workers' host transform ms a sample beside ``detr_transform_ms`` (phase
    train_coco's), the loader wait a step, the step wall and the peak
    memory; returns the run's launches."""
    import shutil

    t0 = time.perf_counter()
    root = TRAIN_COCO_DIR.parent / "chip_smoke_train_strong"
    if root.exists():
        shutil.rmtree(root)
    img_dir, ann = write_train_split(root, seed=22, polygons=True)
    forwards = sum(1 for _ in DetectionLoader(CocoDetection(str(img_dir), str(ann)), 4))
    real_make, real_cv2 = train_entry.make_train_step, sys.modules.get("cv2", False)
    train_entry.make_train_step = lambda *a, **k: TimedStep(*a, **k)
    sys.modules["cv2"] = None  # import cv2 raises ImportError
    try:
        config = train_coco_config(root / "strong.py", img_dir, ann, root / "run", train_transform="strong_album",
                                   copypaste=True)
        torch.cuda.reset_peak_memory_stats()
        summary, records, launches = run_train_cli(
            ["--config-file", config, "--seed", "3", "--dry-run-steps", str(STRONG_STEPS)], forwards)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        train_entry.make_train_step = real_make
        if real_cv2 is False:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = real_cv2
        TimedStep.last = None
    if len(records) != STRONG_STEPS:
        raise AssertionError(f"train_coco_strong: {len(records)} steps")
    per_step = {k: sum(r["launches"][k] for r in records) / len(records) for k in TRAIN_STEP_KERNELS}
    if per_step != {k: float(v) for k, v in TRAIN_STEP_KERNELS.items()}:
        raise AssertionError(f"train_coco_strong: launches per step {per_step}")
    waits_ms = [1e3 * w for w in summary["loader_waits_s"][:len(records)]]
    transform_ms = 1e3 * summary["transform_s"] / max(summary["samples"], 1)
    wall = [r["wall_ms"] for r in records]
    counts = [n for r in records for n in r["counts"]]
    print(f"train_coco_strong: flagship R50 bf16 B=4 strong_album + copypaste through "
          f"salience_detr_torch.train.main with cv2 blocked, {len(TRAIN_COCO_SIZES)} .npy images with polygon "
          f"masks, {len(records)} steps + eval; canvases {sorted({r['canvas'] for r in records})}; gts per image "
          f"after copy-paste min {min(counts)} max {max(counts)}; launches per step {per_step}, in all "
          f"{ {k: v for k, v in launches.items() if v} } with {forwards} eval forwards; "
          f"host_transform_ms_per_sample={transform_ms:.3f} (detr in phase train_coco "
          f"{detr_transform_ms:.3f}; 8 worker threads, 1 intra-op thread each; copy-paste runs in the loader's "
          f"batch thread, not counted there); loader_wait_ms per step={[round(x, 3) for x in waits_ms]} "
          f"mean={statistics.mean(waits_ms):.3f}; step wall_ms={[round(x, 3) for x in wall]} median="
          f"{statistics.median(wall):.3f} device_ms={[round(r['device_ms'], 3) for r in records]}; "
          f"peak_mem_gib={peak_gib:.3f}; loss={summary['metrics']['loss']:.4f} eval AP="
          f"{summary['stats']['AP']:.6f}, finite; phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return launches


# the DCN layers of the R50-DCN config at B=4 on the 800x1344 canvas: (Cin,
# input height, width, stride, layers of this shape); conv2 of every block of
# stages 2-4, the first of each stage at stride 2
DCN_LAYERS = [(128, 200, 336, 2, 1), (128, 100, 168, 1, 3), (256, 100, 168, 2, 1), (256, 50, 84, 1, 5),
              (512, 50, 84, 2, 1), (512, 25, 42, 1, 2)]
DCN_HOT = (128, 100, 168, 1)  # the kernels line's shape: the largest columns (155 MB in bf16)
DCN_STAGES = (False, True, True, True)
DCN_CONFIG = Path(__file__).resolve().parent / "configs" / "salience_detr_torch" / "salience_detr_resnet50_dcn_800_1333.py"
DCN_PARTS = (".conv2.conv_offset.", ".conv2.conv_mask.", ".conv2.deform_conv2d.")


def steady_ms(fn, iters, reps=3):
    """The least of ``reps`` means of ``iters`` calls each: a stall of the
    host or the allocator inside one run does not reach the result."""
    return min(cuda_ms(fn, iters) for _ in range(reps))


def dcn_valid_corners(offsets, H, W, stride):
    """The in-image corners of all taps of these offsets."""
    py, px = dcn_ops._tap_positions(offsets, stride)
    return sum(int(valid.sum()) for valid, *_ in dcn_ops._corners(py, px, H, W))


def dcn_bounds(x, offsets, mask, stride):
    """Bounds of the DCN forward and backward functions on these inputs.
    The forward reads x, offsets and mask (f32, as the kernel takes them)
    and writes the columns in x's dtype; 2 operations per channel of each
    in-image corner and 1 for the mask.  The backward reads x, d_cols,
    offsets and mask and writes d_x in x's dtype, d_offsets and d_mask (f32):
    the function's bytes, whatever scratch an implementation adds; per
    channel of each in-image corner 2 dot products and the d_x add (6
    operations), and the masked gradient (1)."""
    B, H, W, C = x.shape
    taps = offsets[..., 0].numel() * 9
    valid = dcn_valid_corners(offsets, H, W, stride)
    small = 4 * (offsets.numel() + mask.numel())
    cols = taps * C * x.element_size()
    forward = bound(nbytes(x) + small + cols, (2 * valid + taps) * C)
    backward = bound(2 * nbytes(x) + cols + 2 * small, (6 * valid + taps) * C)
    return forward, backward, valid / (4 * taps)


def grid_sample_calls(x, offsets, stride, dtype):
    """One ``F.grid_sample`` over (B, Ho, Wo * 9) points, the same bilinear
    zero-padded sampling without the mask (align_corners=True puts -1 and 1
    on the centres of the first and last pixel), and its autograd backward:
    the DCN kernels' library yardsticks.  grid_sample takes its grid in the
    input's dtype; in bf16 the normalised positions lose up to 0.65 px at
    W = 336, so its f32 time is the yardstick and its bf16 time a fact."""
    B, H, W, C = x.shape
    Ho, Wo = offsets.shape[1:3]
    py, px = dcn_ops._tap_positions(offsets, stride)
    grid = torch.stack([px * (2.0 / (W - 1)) - 1, py * (2.0 / (H - 1)) - 1], -1).reshape(B, Ho, Wo * 9, 2)
    xn = x.to(dtype).permute(0, 3, 1, 2).detach().requires_grad_()
    grid = grid.to(dtype).requires_grad_()
    out = torch.nn.functional.grid_sample(xn, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    d_out = torch.randn_like(out)

    def forward():
        with torch.no_grad():
            return torch.nn.functional.grid_sample(xn, grid, mode="bilinear", padding_mode="zeros",
                                                   align_corners=True)

    return forward, lambda: torch.autograd.grad(out, (xn, grid), d_out, retain_graph=True)


def dcn_forward_launcher(x, offsets, mask, stride):
    """A launch-only call of a library's DCN forward kernel on these inputs
    (offsets and mask cast to f32 once, the output allocated once); returns
    it and the output."""
    B, H, W, C = x.shape
    Ho, Wo = offsets.shape[1:3]
    off, msk = offsets.float().contiguous(), mask.float().contiguous()
    cols = torch.empty(B, Ho, Wo, 9, C, dtype=x.dtype, device=x.device)
    bf16, stream = int(x.dtype == torch.bfloat16), native.stream_of(x)

    def forward(lib):
        native.check(lib.deform_conv_forward(x.data_ptr(), bf16, off.data_ptr(), msk.data_ptr(), cols.data_ptr(),
                                             B, H, W, C, stride, stream), "deform_conv_forward")

    return forward, cols


# the C entry points of the DCN backward designs: the shipped gather, the
# halo push (tools/dcn_halo/, a baseline directory) and the earlier
# per-corner atomic push (``deform_conv_backward``, in csrc/ of older commits)
DCN_BACKWARD_ENTRIES = ("deform_conv_backward_gather", "deform_conv_backward_halo", "deform_conv_backward")


def dcn_backward_call(x, offsets, mask, stride, d_cols):
    """One whole backward call of a library on these inputs, through the
    entry point it has, as its wrapper makes it: the gather (its seven
    launches into a workspace allocated once, d_x written in x's dtype), the
    halo push (an f32 d_x that the entry zeroes, the launch, the cast to x's
    dtype) or the earlier per-corner atomic push (a zeroed f32 scratch, the
    launch, the cast).
    Offsets and mask are cast to f32 once.  Returns run(lib) -> (d_x,
    d_offsets, d_mask)."""
    B, H, W, C = x.shape
    off, msk = offsets.float().contiguous(), mask.float().contiguous()
    d_off, d_msk = torch.empty_like(off), torch.empty_like(msk)
    d_x = torch.empty_like(x)
    bf16, stream = int(x.dtype == torch.bfloat16), native.stream_of(x)
    workspaces = {}

    def run(lib):
        args = (x.data_ptr(), bf16, off.data_ptr(), msk.data_ptr(), d_cols.data_ptr())
        if hasattr(lib, "deform_conv_backward_gather"):
            if id(lib) not in workspaces:
                size = lib.deform_conv_backward_workspace(B, H, W, C, stride)
                workspaces[id(lib)] = torch.empty(size, dtype=torch.uint8, device=x.device)
            native.check(lib.deform_conv_backward_gather(*args, d_x.data_ptr(), d_off.data_ptr(), d_msk.data_ptr(),
                                                         workspaces[id(lib)].data_ptr(), B, H, W, C, stride, stream),
                         "deform_conv_backward_gather")
            return d_x, d_off, d_msk
        if hasattr(lib, "deform_conv_backward_halo"):
            scratch = torch.empty(B, H, W, C, device=x.device)
            entry = lib.deform_conv_backward_halo
        else:
            scratch = torch.zeros(B, H, W, C, device=x.device)
            entry = lib.deform_conv_backward
        native.check(entry(*args, scratch.data_ptr(), d_off.data_ptr(), d_msk.data_ptr(), B, H, W, C, stride,
                           stream), "DCN backward")
        return scratch.to(x.dtype), d_off, d_msk

    return run


def dcn_backward_checks(x, offsets, mask, stride, d_cols, label):
    """B6's backward through autograd (counted) against the plain backward
    and autograd of the plain forward, within BWD_TOL; returns the largest
    error and raises on a violation."""
    inputs = [t.clone().requires_grad_() for t in (x, offsets, mask)]
    before = native.LAUNCHES["deform_conv_backward"]
    dcn_ops.deform_conv_sample(*inputs, stride).backward(d_cols)
    torch.cuda.synchronize()
    if native.LAUNCHES["deform_conv_backward"] != before + 1:
        raise AssertionError("the DCN backward kernel did not run")
    got = [i.grad for i in inputs]
    return check_dcn_grads(got, x, offsets, mask, stride, d_cols, label, autograd=True)


def check_dcn_grads(got, x, offsets, mask, stride, d_cols, label, autograd=False):
    """(d_x, d_offsets, d_mask) against the plain backward (and autograd of
    the plain forward) within BWD_TOL; the largest error, or raises."""
    refs = [("plain", dcn_ops.deform_conv_sample_backward_plain(x, offsets, mask, stride, d_cols))]
    if autograd:
        auto = [t.clone().requires_grad_() for t in (x, offsets, mask)]
        dcn_ops.deform_conv_sample_plain(*auto, stride).backward(d_cols)
        refs.append(("autograd", [a.grad for a in auto]))
    torch.cuda.synchronize()
    worst = 0.0
    for ref_name, ref in refs:
        for gname, g, r in zip(("d_x", "d_offsets", "d_mask"), got, ref):
            err, _, bad, _, _ = compare_bwd(g, r)
            if bad:
                raise AssertionError(f"deform_conv backward {gname} disagrees with {ref_name} on {label}: "
                                     f"{bad} elements")
            worst = max(worst, err)
    return worst


def dcn_bins(offsets, H, W, stride):
    """The gather backward's lists on these offsets: entries (in-image
    corners) per input pixel, mean and max, and the share of pixels whose
    list is longer than the 128 keys sorted in registers; and the share of
    taps with an offset beyond the halo design's 2 px margin."""
    py, px = dcn_ops._tap_positions(offsets, stride)
    counts = torch.zeros(offsets.shape[0] * H * W, dtype=torch.int64, device=offsets.device)
    for valid, idx, *_ in dcn_ops._corners(py, px, H, W):
        counts.index_add_(0, idx[valid], torch.ones_like(idx[valid]))
    off = offsets.float().reshape(*offsets.shape[:-1], 9, 2)
    far = float((off.abs().amax(-1) > 2).float().mean())
    return float(counts.float().mean()), int(counts.max()), float((counts > 128).float().mean()), far


def fused_bound(x, offsets, mask, weight_16, out):
    """(bound_ms, bound_by) of the fused DCN layer: its bytes (x, offsets
    and mask in f32 as the kernel takes them, the kernel and the output in
    x's dtype) over 3.35 TB/s, or its 2 * M * K * N operations over the bf16
    tensor-core rate, whichever is larger."""
    M, F = out[..., 0].numel(), out.shape[-1]
    K = weight_16.shape[0]
    by_bytes = (nbytes(x, weight_16, out) + 4 * (offsets.numel() + mask.numel())) / HBM_BYTES_PER_MS
    by_ops = 2 * M * K * F / BF16_TENSOR_OPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def fused_launcher(x, offsets, mask, w16, stride):
    """A launch-only call of a library's fused DCN kernel on these inputs
    (offsets and mask cast to f32 once, the output allocated once); returns
    it and the output."""
    B, H, W, C = x.shape
    Ho, Wo = offsets.shape[1:3]
    off, msk = offsets.float().contiguous(), mask.float().contiguous()
    F = w16.shape[1]
    out = torch.empty(B, Ho, Wo, F, dtype=x.dtype, device=x.device)
    code, stream = dcn_ops.DTYPE_CODES[x.dtype], native.stream_of(x)

    def launch(lib):
        native.check(lib.deform_conv_fused_forward(x.data_ptr(), code, off.data_ptr(), msk.data_ptr(),
                                                   w16.data_ptr(), out.data_ptr(), B, H, W, C, F, stride, stream),
                     "deform_conv_fused_forward")

    return launch, out


def dcn_fused_checks(x32, offsets, mask, stride, gen, bases, smi):
    """The 16-bit layer (a (9, C, C) kernel) on bf16 and f16 x:
    ``deform_conv2d`` takes the fused kernel alone where
    ``uses_fused_kernel`` says so (F = 128) and the columns kernel alone
    elsewhere; the fused kernel (``_fused_cuda``, at every shape) against
    ``deform_conv2d_plain`` on the card, and its error and the parent's path's
    (the columns kernel, then ``torch.matmul``) against the float32 product
    of the same columns, side by side.  Tolerance: within
    one ulp of x's dtype plus 1e-3 of the largest output of the plain layer
    (the final rounding of f32 sums taken in other orders), and no farther
    from the f32 product than 1.01 times the parent path's own error (both
    are the final rounding, half an ulp; the f32 sums differ by about 1e-6).
    Then, in bf16, the fused layer and the parent's path in turns (parent,
    fused, fused, parent; with ``--baseline-csrc`` the parent's path takes
    each directory's columns kernel), the path's two parts, the plain layer
    and the bound.  Returns (fused ms, parent path ms, columns ms, matmul ms,
    plain ms, bound ms, route ms, bound by, largest error); the route's ms is
    the fused kernel's where the route takes it, else the parent path's (the
    same calls)."""
    B, H, W, C = x32.shape
    weight = torch.randn(9, C, C, generator=gen, device=x32.device) / math.sqrt(9 * C)
    worst, parts = 0.0, []
    for dtype, ulp in ((torch.bfloat16, 2.0 ** -7), (torch.float16, 2.0 ** -10)):
        x = x32.to(dtype)
        fused_route = dcn_ops.uses_fused_kernel(dtype, C)
        before = native.LAUNCHES["deform_conv_fused"], native.LAUNCHES["deform_conv"]
        route = dcn_ops.deform_conv2d(x, offsets, mask, weight, stride)
        torch.cuda.synchronize()
        if (native.LAUNCHES["deform_conv_fused"], native.LAUNCHES["deform_conv"]) != (
                before[0] + fused_route, before[1] + (not fused_route)):
            raise AssertionError(f"deform_conv2d at F={C} {dtype} did not take the "
                                 f"{'fused' if fused_route else 'columns'} kernel alone")
        got = dcn_ops._fused_cuda(x, offsets, mask, weight, stride)
        plain = dcn_ops.deform_conv2d_plain(x, offsets, mask, weight, stride).float()
        w16 = weight.reshape(9 * C, C).to(dtype)
        cols = dcn_ops._forward_cuda(x, offsets, mask, stride)
        parent = torch.matmul(cols.reshape(-1, 9 * C), w16).reshape(got.shape).float()
        ref = torch.matmul(cols.float().reshape(-1, 9 * C), w16.float()).reshape(got.shape)
        if not torch.equal(route.float(), got.float() if fused_route else parent):
            raise AssertionError(f"deform_conv2d at F={C} {dtype} differs from the kernel it took")
        del cols, route
        err = (got.float() - plain).abs()
        top = float(plain.abs().max())
        bad = int((err > ulp * plain.abs() + 1e-3 * top).sum())
        fused_ref, parent_ref = float((got.float() - ref).abs().max()), float((parent - ref).abs().max())
        if bad or fused_ref > 1.01 * parent_ref + 1e-6:
            raise AssertionError(f"fused DCN at C={C} stride={stride} {dtype}: {bad} elements off the plain layer, "
                                 f"error vs the f32 product {fused_ref:.3e} against the parent path's {parent_ref:.3e}")
        worst = max(worst, float(err.max()))
        parts.append(f"{str(dtype)[6:]} max_abs_err vs plain {float(err.max()):.3e} (one ulp + 1e-3 max |out| = "
                     f"{ulp:.2e} rel + {1e-3 * top:.2e}); vs the f32 product fused {fused_ref:.3e} parent path "
                     f"{parent_ref:.3e}")
        del got, plain, parent, ref
    x = x32.to(torch.bfloat16)
    w16 = weight.reshape(9 * C, C).to(torch.bfloat16)
    new = native.load()
    forward, cols = dcn_forward_launcher(x, offsets, mask, stride)

    def parent_path(lib):
        forward(lib)
        return torch.matmul(cols.reshape(-1, 9 * C), w16)

    def fused():
        return dcn_ops._fused_cuda(x, offsets, mask, weight, stride)

    turns = [cuda_ms(f, 10) for f in (lambda: parent_path(new), fused, fused, lambda: parent_path(new))]
    fused_ms, parent_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    cols_ms = steady_ms(lambda: forward(new), 10)
    matmul_ms = steady_ms(lambda: torch.matmul(cols.reshape(-1, 9 * C), w16), 10)
    plain_ms = cuda_ms(lambda: dcn_ops.deform_conv2d_plain(x, offsets, mask, weight, stride), 3)
    out = fused()
    fb, fby = fused_bound(x, offsets, mask, w16, out)
    route_fused = dcn_ops.uses_fused_kernel(x.dtype, C)
    route_ms = fused_ms if route_fused else parent_ms
    ab = []
    for base_dir, base in bases:
        if hasattr(base, "deform_conv_forward"):
            t = [cuda_ms(f, 10) for f in (lambda: parent_path(base), fused, fused, lambda: parent_path(base))]
            ab.append(f"baseline={base_dir} parent path (its columns kernel + torch.matmul) / fused / fused / parent "
                      f"path ms {[round(v, 4) for v in t]}")
        if hasattr(base, "deform_conv_fused_forward"):
            launch, base_out = fused_launcher(x, offsets, mask, w16, stride)
            launch(base)
            torch.cuda.synchronize()
            plain = dcn_ops.deform_conv2d_plain(x, offsets, mask, weight, stride).float()
            base_err = float((base_out.float() - plain).abs().max())
            t = [cuda_ms(lambda: launch(lib_), 10) for lib_ in (base, new, new, base)]
            ab.append(f"baseline={base_dir} its fused kernel (max_abs_err vs plain {base_err:.3e}) launch only "
                      f"base/new/new/base ms {[round(v, 4) for v in t]}, bound share base "
                      f"{2 * fb / (t[0] + t[3]):.3f} new {2 * fb / (t[1] + t[2]):.3f}")
            del plain, base_out
    print(f"deform_conv_fused: C=F={C} x {B}x{H}x{W} stride={stride}; {'; '.join(parts)}; bf16 in turns parent path "
          f"(columns kernel + torch.matmul) / fused / fused / parent path ms {[round(v, 4) for v in turns]}: fused "
          f"{fused_ms:.4f} parent path {parent_ms:.4f} (columns {cols_ms:.4f} + matmul {matmul_ms:.4f}); plain_ms="
          f"{plain_ms:.4f} bound_ms={fb:.4f} ({'bf16 tensor ops' if fby == 'operations' else fby}), share "
          f"{fb / fused_ms:.3f}; route (deform_conv2d) {'fused' if route_fused else 'columns + matmul'} "
          f"{route_ms:.4f}; card: {smi}")
    for line in ab:
        print(f"dcn_ab: fused C={C} {H}x{W} stride={stride} bf16 {line}; card: {smi}")
    del cols, out
    return fused_ms, parent_ms, cols_ms, matmul_ms, plain_ms, fb, route_ms, fby, worst


def phase_deform_conv(smi, baselines=()):
    """B6 at each distinct DCN layer shape of R50-DCN (B=4, 800x1344 canvas):
    x normal, offsets normal with std 2 px (taps off the pixel grid, some
    outside the image), masks uniform in (0, 1).  The forward kernel bitwise
    equal to its plain version in f32 (TF32 off) and bf16 (any element off
    fails the phase); the backward kernel against
    the plain backward and autograd of the plain forward; times of both (bf16,
    with the wrapper; the kernels' and F.grid_sample's by ``steady_ms``),
    their plain versions and F.grid_sample, bounds, and
    the totals over the 13 layers of one forward.  Returns the largest
    errors and (ms, plain ms, bound ms, bound by, library ms) of each kernel
    at DCN_HOT.  With ``--baseline-csrc``, each directory's DCN kernels are
    timed in turns with these at every shape (``dcn_ab:``): the forward
    launch only (its columns held equal to this one's; each kernel's share of
    the bound), the backward as whole calls (``dcn_backward_call``), the
    baseline's gradients held against the plain backward first."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    new = native.load()
    bases = [(d, baseline_library(d)) for d in baselines]
    bases = [(d, lib) for d, lib in bases if any(
        hasattr(lib, e) for e in ("deform_conv_forward", "deform_conv_fused_forward") + DCN_BACKWARD_ENTRIES)]
    fwd_err = bwd_err = fused_err = 0.0
    totals = np.zeros(8)
    fused_totals = np.zeros(7)
    hot = fused_hot = None
    for C, H, W, stride, count in DCN_LAYERS:
        B, Ho, Wo = 4, dcn_ops.output_size(H, stride), dcn_ops.output_size(W, stride)
        x32 = torch.randn(B, H, W, C, generator=gen, device=dev)
        offsets = torch.randn(B, Ho, Wo, 18, generator=gen, device=dev) * 2
        mask = torch.rand(B, Ho, Wo, 9, generator=gen, device=dev)
        parts = []
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got, want = dcn_ops.deform_conv_sample(x, offsets, mask, stride), dcn_ops.deform_conv_sample_plain(
                x, offsets, mask, stride)
            torch.cuda.synchronize()
            max_abs, _, bad, atol, rtol = compare(got, want, dtype)
            exact = int((got != want).sum())
            if bad or exact:
                raise AssertionError(f"deform_conv forward differs from plain at C={C} stride={stride} {dtype}: "
                                     f"{exact} elements ({bad} beyond atol {atol} rtol {rtol})")
            fwd_err = max(fwd_err, max_abs)
            del got, want
            d_cols = torch.randn(B, Ho, Wo, 9, C, generator=gen, device=dev).to(dtype)
            bwd_err = max(bwd_err, dcn_backward_checks(x, offsets, mask, stride, d_cols,
                                                       f"C={C} stride={stride} {dtype}"))
            parts.append(f"{str(dtype)[6:]} forward max_abs_err={max_abs:.3e} (atol {atol} rtol {rtol}) "
                         f"not_bit_equal={exact}; backward vs plain and autograd within "
                         f"{BWD_TOL[torch.float32 if dtype == torch.float32 else torch.bfloat16]}")
        x = x32.to(torch.bfloat16)
        d_cols = torch.randn(B, Ho, Wo, 9, C, generator=gen, device=dev).to(torch.bfloat16)
        (fb, fby), (bb, bby), in_image = dcn_bounds(x, offsets, mask, stride)
        fwd_ms = steady_ms(lambda: dcn_ops.deform_conv_sample(x, offsets, mask, stride), 10)
        fwd_plain = cuda_ms(lambda: dcn_ops.deform_conv_sample_plain(x, offsets, mask, stride), 3)
        bwd_ms = steady_ms(lambda: dcn_ops._backward_cuda(x, offsets, mask, stride, d_cols), 10)
        bwd_plain = cuda_ms(lambda: dcn_ops.deform_conv_sample_backward_plain(x, offsets, mask, stride, d_cols), 3)
        lib_f32, lib_bwd_f32 = grid_sample_calls(x32, offsets, stride, torch.float32)
        check = lib_f32().reshape(B, C, Ho, Wo, 9).permute(0, 2, 3, 4, 1)
        lib_err = float((check - dcn_ops.deform_conv_sample_plain(x32, offsets, torch.ones_like(mask), stride)).abs().max())
        lib_ms, lib_bwd_ms = steady_ms(lib_f32, 10), steady_ms(lib_bwd_f32, 5)
        del lib_f32, lib_bwd_f32, check
        lib_bf16, lib_bwd_bf16 = grid_sample_calls(x32, offsets, stride, torch.bfloat16)
        lib_bf16_ms, lib_bwd_bf16_ms = cuda_ms(lib_bf16, 10), cuda_ms(lib_bwd_bf16, 5)
        del lib_bf16, lib_bwd_bf16
        row = np.array([fwd_ms, fwd_plain, fb, lib_ms, bwd_ms, bwd_plain, bb, lib_bwd_ms])
        totals += count * row
        if (C, H, W, stride) == DCN_HOT:
            hot = ((fwd_ms, fwd_plain, fb, fby, lib_ms), (bwd_ms, bwd_plain, bb, bby, lib_bwd_ms))
        print(f"deform_conv: C={C} x {B}x{H}x{W} stride={stride} -> {Ho}x{Wo}, {count} layer(s) of R50-DCN; "
              f"in-image corners {in_image:.4f}; {'; '.join(parts)}; bf16 forward kernel_ms={fwd_ms:.4f} "
              f"plain_ms={fwd_plain:.4f} bound_ms={fb:.4f} ({fby}), share {fb / fwd_ms:.3f} library_ms={lib_ms:.4f} "
              f"(grid_sample f32, max_abs_err vs plain without mask {lib_err:.3e}; bf16 grid {lib_bf16_ms:.4f}); backward "
              f"kernel_ms={bwd_ms:.4f} plain_ms={bwd_plain:.4f} bound_ms={bb:.4f} ({bby}) library_ms={lib_bwd_ms:.4f} "
              f"(grid_sample autograd f32; bf16 {lib_bwd_bf16_ms:.4f}); card: {smi}")
        for base_dir, base in bases:
            parts = []
            if hasattr(base, "deform_conv_forward"):
                forward, cols = dcn_forward_launcher(x, offsets, mask, stride)
                turns = in_turns(forward, base, new, 20)
                parts.append(f"forward ms base/new/new/base {[round(v, 4) for v in turns]} "
                             f"same_output={same_output(forward, cols, base, new)} bound {fb:.4f}, share base "
                             f"{2 * fb / (turns[0] + turns[3]):.3f} new {2 * fb / (turns[1] + turns[2]):.3f}")
            if any(hasattr(base, e) for e in DCN_BACKWARD_ENTRIES):
                backward = dcn_backward_call(x, offsets, mask, stride, d_cols)
                err = check_dcn_grads(backward(base), x, offsets, mask, stride, d_cols, f"baseline {base_dir}")
                parts.append(f"backward (whole calls) ms base/new/new/base "
                             f"{[round(v, 4) for v in in_turns(backward, base, new, 10)]} bound {bb:.4f}, "
                             f"baseline max_abs_err vs plain {err:.3e}")
            print(f"dcn_ab: C={C} {H}x{W} stride={stride} bf16 baseline={base_dir}: {'; '.join(parts)}; card: {smi}")
        del x, d_cols
        f = dcn_fused_checks(x32, offsets, mask, stride, gen, bases, smi)
        fused_totals += count * np.array(f[:7])
        fused_err = max(fused_err, f[8])
        if (C, H, W, stride) == DCN_HOT:
            fused_hot = (f[0], f[4], f[5], f[7], None)
        del x32, offsets, mask
    print(f"deform_conv_fused: the 13 layers of one R50-DCN forward, bf16: fused kernel_ms={fused_totals[0]:.4f}; "
          f"parent path (columns kernel + torch.matmul, in turns) ms={fused_totals[1]:.4f} (columns "
          f"{fused_totals[2]:.4f} + matmul {fused_totals[3]:.4f}); plain_ms={fused_totals[4]:.4f} bound_ms="
          f"{fused_totals[5]:.4f}, share {fused_totals[5] / fused_totals[0]:.3f}; route (deform_conv2d: fused at "
          f"F = 128, columns + matmul above) ms={fused_totals[6]:.4f} against the parent path's "
          f"{fused_totals[1]:.4f}; card: {smi}")
    print(f"deform_conv: the 13 layers of one R50-DCN forward/step, bf16: forward kernel_ms={totals[0]:.4f} "
          f"plain_ms={totals[1]:.4f} bound_ms={totals[2]:.4f} library_ms={totals[3]:.4f}; backward "
          f"kernel_ms={totals[4]:.4f} plain_ms={totals[5]:.4f} bound_ms={totals[6]:.4f} library_ms={totals[7]:.4f}; "
          f"phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return fwd_err, bwd_err, hot, fused_err, fused_hot


def capture_dcn_train_inputs():
    """What one R50-DCN train step (``Trainer``, B=4, 800x1344, bf16
    autocast), its offset and mask convs at seeded small normals
    (``offsets_off_grid``), gives the DCN sampling: x, offsets, mask, stride
    and d_cols of each of its 13 layers, recorded by a wrapper around the
    DCN modules' call of ``deform_conv2d`` that runs the layer as the
    columns and their product."""
    trainer = Trainer(load_config(DCN_CONFIG), "cuda", seed=0, steps_per_epoch=1)
    offsets_off_grid(trainer.model)
    batch = next(trainer.batches(1, seed=0, counts=GT_COUNTS))
    calls, real = [], dcn_module.deform_conv2d

    def recording(x, offsets, mask, weight, stride):
        # the layer as the columns and their product, so that d_cols exists
        cols = dcn_ops.deform_conv_sample(x, offsets, mask, stride)
        call = {"x": x.detach(), "offsets": offsets.detach(), "mask": mask.detach(), "stride": stride,
                "weight": weight.detach()}
        cols.register_hook(lambda grad: call.__setitem__("d_cols", grad.detach()))
        calls.append(call)
        return dcn_ops._product(cols, weight)

    dcn_module.deform_conv2d = recording
    try:
        trainer.step(batch, trainer.generator)
    finally:
        dcn_module.deform_conv2d = real
    torch.cuda.synchronize()
    if len(calls) != 13 or any("d_cols" not in c for c in calls):
        raise AssertionError(f"{len(calls)} DCN calls in one R50-DCN train step, "
                             f"{sum('d_cols' in c for c in calls)} with a gradient")
    return calls


def phase_dcn_captured(smi, baselines):
    """B6's backward on the inputs the 13 DCN layers of an R50-DCN train step
    give it (``capture_dcn_train_inputs``), and on the same with offsets of
    std 8 px in place of the captured ones (far taps): against the plain
    backward and autograd of the plain forward (BWD_TOL), d_x bitwise equal
    over two calls, the gather's list sizes and the share of taps beyond the
    halo design's margin, times (with the wrapper), bounds; with
    ``--baseline-csrc``, each directory's backward as whole calls in turns
    with the shipped one per layer, and the totals over the 13 layers."""
    t0 = time.perf_counter()
    calls = capture_dcn_train_inputs()
    new = native.load()
    bases = [(d, baseline_library(d)) for d in baselines]
    bases = [(d, lib) for d, lib in bases if any(hasattr(lib, e) for e in DCN_BACKWARD_ENTRIES)]
    gen = torch.Generator(device="cuda").manual_seed(24)
    totals = {}
    worst = 0.0
    for i, c in enumerate(calls):
        x, mask, stride, d_cols = c["x"], c["mask"], c["stride"], c["d_cols"]
        B, H, W, C = x.shape
        far = torch.randn(c["offsets"].shape, generator=gen, device="cuda") * 8
        for label, offsets in (("captured", c["offsets"]), ("std 8 px", far.to(c["offsets"].dtype))):
            name = f"layer {i} C={C} {H}x{W} stride={stride} {label}"
            err = dcn_backward_checks(x, offsets, mask, stride, d_cols, name)
            worst = max(worst, err)
            first = dcn_ops._backward_cuda(x, offsets, mask, stride, d_cols)
            second = dcn_ops._backward_cuda(x, offsets, mask, stride, d_cols)
            torch.cuda.synchronize()
            repeatable = all(torch.equal(a, b) for a, b in zip(first, second))
            if not repeatable:
                raise AssertionError(f"dcn_captured: two backward calls differ on {name}")
            del first, second
            mean, most, long_share, far_share = dcn_bins(offsets, H, W, stride)
            _, (bb, bby), in_image = dcn_bounds(x, offsets, mask, stride)
            ms = steady_ms(lambda: dcn_ops._backward_cuda(x, offsets, mask, stride, d_cols), 10)
            row = totals.setdefault(label, {"ms": 0.0, "bound": 0.0})
            row["ms"] += ms
            row["bound"] += bb
            ab = []
            for base_dir, base in bases:
                run = dcn_backward_call(x, offsets, mask, stride, d_cols)
                base_err = check_dcn_grads(run(base), x, offsets, mask, stride, d_cols, f"{name} baseline {base_dir}")
                turns = in_turns(run, base, new, 10)
                row[base_dir] = np.add(row.get(base_dir, np.zeros(4)), turns)
                ab.append(f"baseline={base_dir} base/new/new/base {[round(v, 4) for v in turns]} "
                          f"(baseline max_abs_err vs plain {base_err:.3e})")
            print(f"dcn_captured: {name} {str(x.dtype)[6:]} offsets {str(offsets.dtype)[6:]}: in-image corners "
                  f"{in_image:.4f}, taps beyond 2 px {far_share:.4f}; list entries per pixel mean {mean:.2f} max "
                  f"{most}, pixels over 128 {long_share:.6f}; backward vs plain and autograd max_abs_err {err:.3e}, "
                  f"d_x bitwise repeatable; kernel_ms={ms:.4f} bound_ms={bb:.4f} ({bby}); {'; '.join(ab)}; "
                  f"card: {smi}")
        del c["d_cols"]
    for label, row in totals.items():
        ab = "; ".join(f"baseline={d} base/new/new/base {[round(float(v), 4) for v in row[d]]}" for d, _ in bases)
        print(f"dcn_captured: the 13 layers, {label} offsets: kernel_ms={row['ms']:.4f} bound_ms={row['bound']:.4f}; "
              f"{ab}; card: {smi}")
    fused_route_on_captured(calls, smi)
    print(f"dcn_captured: largest error {worst:.3e}; phase_s={time.perf_counter() - t0:.2f}")


def fused_route_on_captured(calls, smi):
    """The 16-bit layer's two CUDA routes on the 13 captured R50-DCN
    layers' own inputs (x, offsets, mask and the kernel of the train step):
    the fused kernel against the plain layer (one ulp + 1e-3 of its largest
    output, as ``dcn_fused_checks``), then the fused kernel and the columns
    kernel + ``torch.matmul`` in turns (columns, fused, fused, columns),
    per layer and summed by F: what ``FUSED_MAX_F`` is set from."""
    by_f = {}
    for i, c in enumerate(calls):
        x, offsets, mask, stride, weight = c["x"], c["offsets"], c["mask"], c["stride"], c["weight"]
        C, F = x.shape[-1], weight.shape[-1]
        with torch.autocast("cuda", enabled=False):
            fused = lambda: dcn_ops._fused_cuda(x, offsets, mask, weight, stride)  # noqa: E731
            columns = lambda: dcn_ops._product(dcn_ops._forward_cuda(x, offsets, mask, stride), weight)  # noqa: E731
            got = fused().float()
            plain = dcn_ops.deform_conv2d_plain(x, offsets, mask, weight, stride).float()
            ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -10
            bad = int(((got - plain).abs() > ulp * plain.abs() + 1e-3 * float(plain.abs().max())).sum())
            if bad:
                raise AssertionError(f"dcn_captured: the fused kernel is off the plain layer at layer {i}: "
                                     f"{bad} elements")
            turns = [cuda_ms(f, 10) for f in (columns, fused, fused, columns)]
        row = by_f.setdefault(F, np.zeros(4))
        row += turns
        print(f"dcn_captured: layer {i} C={C} F={F} {tuple(x.shape[1:3])} stride={stride} {str(x.dtype)[6:]}: fused "
              f"max_abs_err vs plain {float((got - plain).abs().max()):.3e}; columns + matmul / fused / fused / "
              f"columns + matmul ms {[round(v, 4) for v in turns]}; card: {smi}")
        del got, plain
    parts = [f"F={F} ({len([c for c in calls if c['weight'].shape[-1] == F])} layers) columns + matmul / fused / "
             f"fused / columns + matmul {[round(float(v), 4) for v in row]}" for F, row in sorted(by_f.items())]
    print(f"dcn_captured: the routes on the captured layers, summed by F: {'; '.join(parts)}; route FUSED_MAX_F="
          f"{dcn_ops.FUSED_MAX_F}; card: {smi}")


def phase_dcn_slice():
    """The small model with DCN stages 2-4, card (kernels) against CPU (plain
    versions): the forward, then one train step, as phases 5 and 9; then the
    train step on the card once more under float16 autocast: finite losses;
    of its 6 DCN layers (F = 128, 128, 256, 256, 512, 512) 2 fused and 4
    columns launches in forward, 6 columns (the recompute) and 6 gather
    launches in backward; every DCN parameter moves."""
    before = native.LAUNCHES["deform_conv"], native.LAUNCHES["deform_conv_backward"]
    phase_slice("dcn_slice", DCN_STAGES)
    phase_train_slice("dcn_slice", DCN_STAGES)
    if (native.LAUNCHES["deform_conv"], native.LAUNCHES["deform_conv_backward"]) <= before:
        raise AssertionError("dcn_slice: the DCN kernels did not run on the card")
    # the same train step under float16 autocast (the train CLI's
    # --mixed-precision fp16): the forward (fused at F = 128, columns above),
    # the columns' recompute and the gather backward in float16
    counts = dict(native.LAUNCHES)
    metrics, _, grads, after, _, _, before_step = small_train_step(
        "cuda", stage_with_dcn=DCN_STAGES, fields={"dtype": torch.float16})
    torch.cuda.synchronize()
    launches = {k: native.LAUNCHES[k] - counts[k] for k in ("deform_conv_fused", "deform_conv", "deform_conv_backward")}
    dcn = [n for n in after if n.startswith("backbone.") and any(p in n for p in DCN_PARTS)]
    unmoved = [n for n in dcn if torch.equal(after[n], before_step[n])]
    finite = all(np.isfinite(v) for v in metrics.values())
    print(f"dcn_slice: small train step under float16 autocast: loss={metrics['loss']:.4f} all {len(metrics)} metrics "
          f"finite={finite}; launches {launches}; DCN parameters {len(dcn)}, moved {len(dcn) - len(unmoved)}, "
          f"with a gradient {sum(n in grads for n in dcn)}")
    want = {"deform_conv_fused": 2, "deform_conv": 4 + 6, "deform_conv_backward": 6}
    if not finite or unmoved or len(dcn) != 30 or launches != want:
        raise AssertionError(f"dcn_slice: the float16 DCN train step failed: unmoved {unmoved[:4]}, "
                             f"launches {launches}")


def phase_dcn_serve(smi):
    """R50-DCN through ``Predictor`` with its offset and mask convs at seeded
    small normals: per forward 4 fused DCN launches (stage 2, F = 128) and 9
    columns launches (stages 3-4, F = 256 and 512) beside the 12 MSDA and 1
    grid-NMS; then how far one layer's taps moved off the pixel grid."""
    cfg = load_config(DCN_CONFIG)
    launches, predictor, inputs = phase_serve(smi, "dcn_serve", cfg, "R50-DCN (DCNv2 in stages 2-4)",
                                              offsets_off_grid, {"deform_conv_fused": 4, "deform_conv": 9})
    model = predictor.model
    if sum(isinstance(m, DeformConv2dPack) for m in model.modules()) != 13:
        raise AssertionError("the R50-DCN config does not hold 13 DCN layers")
    seen = {}
    hook = model.backbone.layer2[1].conv2.conv_offset.register_forward_hook(
        lambda m, i, o: seen.update(off=o.detach().float()))
    predictor.forward(*inputs)
    hook.remove()
    off = seen["off"]
    print(f"dcn_serve: layer2.1.conv2 offsets on the timed batch: mean |offset| {float(off.abs().mean()):.4f} px, "
          f"max {float(off.abs().max()):.4f} px, off the pixel grid (> 1e-3 px) "
          f"{float(((off - off.round()).abs() > 1e-3).float().mean()):.4f}")
    return launches


def phase_dcn_train(smi):
    """R50-DCN through ``Trainer``: per step 4 fused DCN forward launches
    (stage 2), 9 + 13 columns launches (stages 3-4's forward, then every
    layer's recompute in backward) and 13 DCN backward launches beside the
    flagship's (no DCN layer's input is frozen: the first
    one follows layer2.0.conv1, which trains), and every DCN parameter
    moves."""
    return phase_train(smi, "dcn_train", load_config(DCN_CONFIG), "R50-DCN (DCNv2 in stages 2-4)",
                       offsets_off_grid, {"deform_conv_fused": 4, "deform_conv": 9 + 13, "deform_conv_backward": 13},
                       DCN_PARTS)


def capture_serve_encoder():
    """value, locations and weights of the first encoder layer (G=1) of a
    flagship serve forward (B=4, the TIMED_BATCH canvas, random weights from
    seed 0), recorded by a wrapper around the MSDA modules' call."""
    cfg = load_config(DEFAULT_CONFIG)
    predictor = Predictor(cfg, None, "cuda", seed=0)
    inputs = preprocess(make_requests(TIMED_BATCH, 7), cfg, "cuda")
    captured, real = {}, attention.ms_deform_attn

    def recording(value, spatial_shapes, locations, weights):
        if not captured:
            captured.update(value=value, locations=locations, weights=weights,
                            levels=[tuple(x) for x in spatial_shapes])
        return real(value, spatial_shapes, locations, weights)

    attention.ms_deform_attn = recording
    try:
        predictor.forward(*inputs)
    finally:
        attention.ms_deform_attn = real
    torch.cuda.synchronize()
    if captured["levels"] != LEVELS or captured["locations"].shape[2] != 1:
        raise AssertionError(f"captured encoder layer: levels {captured['levels']}, "
                             f"locations {tuple(captured['locations'].shape)}")
    return captured


def q8_launchers(value, locs5, weights):
    """Launch-only calls of a library's int8 quantise and sample kernels on
    these inputs (the sampler reads the shipped quantisation's table)."""
    B, S, C = value.shape
    Q, L, P = locs5.shape[1:4]
    H = weights.shape[2]
    absmax = torch.zeros(C, dtype=torch.int32, device=value.device)
    table, scale = torch.empty(B, S, C, dtype=torch.int8, device=value.device), torch.empty(C, device=value.device)
    ref_table, ref_scale = q8_quantize(value)
    loc32, attn32 = locs5.float().contiguous(), weights.float().contiguous()
    out = torch.empty(B, Q, C, dtype=value.dtype, device=value.device)
    bf16, stream, levels = int(value.dtype == torch.bfloat16), native.stream_of(value), native.level_table(LEVELS)

    def quantize(lib):
        absmax.zero_()
        native.check(lib.msda_q8_quantize(value.data_ptr(), bf16, absmax.data_ptr(), table.data_ptr(),
                                          scale.data_ptr(), B * S, C, stream), "msda_q8_quantize")

    def sample(lib):
        native.check(lib.msda_q8_sample(ref_table.data_ptr(), ref_scale.data_ptr(), levels, loc32.data_ptr(),
                                        attn32.data_ptr(), out.data_ptr(), bf16, B, S, Q, C, H, P, stream),
                     "msda_q8_sample")

    return quantize, sample, (table, scale), out


def phase_msda_q8(smi, baselines=()):
    """B8 at the encoder's flagship shape (B=4, Q=11403, G=1, bf16) on uniform
    inputs and on a served forward's captured encoder-layer-0 inputs: the
    int8 table and scale exactly equal to the plain quantisation's, the
    sampler bitwise equal to its plain version on that table, the whole against K1
    on the same inputs within the quantisation and rounding bound (per
    channel scale * (1/2 + 127 * 2**-8) * the head's attention sum: half a
    step, and the bf16 roundings of the corner weights and corner sums),
    plus K1's bf16 bound; times and bounds.  Returns the sampler's largest
    error and the captured inputs' (ms, plain ms, bound, bound by) of both
    kernels.
    With ``--baseline-csrc``, each directory's int8 kernels are timed launch
    only in turns with these (``q8_ab:``; each baseline's table and scale,
    and its sampler's output, compared with this one's; the quantise's share
    of its bound)."""
    t0 = time.perf_counter()
    new = native.load()
    bases = [(d, baseline_library(d)) for d in baselines]
    bases = [(d, lib) for d, lib in bases if hasattr(lib, "msda_q8_sample")]
    gen = torch.Generator(device="cuda").manual_seed(22)
    value32, locs, weights = uniform_msda_inputs(gen, 1, 11403)
    sets = {"uniform": (value32.to(torch.bfloat16), locs, weights.to(torch.bfloat16))}
    del value32
    c = capture_serve_encoder()
    sets["captured serve"] = (c["value"], c["locations"], c["weights"])
    del c
    s_err = 0.0
    timing = None
    for name, (value, locs6, weights) in sets.items():
        locs5 = locs6[:, :, 0].contiguous()
        B, S, C = value.shape
        Q, H = locs6.shape[1], weights.shape[2]
        table, scale = q8_quantize(value)
        want_table, want_scale = q8_quantize_plain(value)
        torch.cuda.synchronize()
        table_diff = int((table != want_table).sum()) + int((scale != want_scale).sum())
        if table_diff:
            raise AssertionError(f"msda_q8 table differs from the plain quantisation in {table_diff} entries ({name})")
        got = q8_sample(table, scale, LEVELS, locs5, weights, value.dtype)
        want = q8_sample_plain(table, scale, LEVELS, locs5, weights, value.dtype)
        torch.cuda.synchronize()
        max_abs, _, bad, atol, rtol = compare(got, want, value.dtype)
        not_equal = int((got != want).sum())
        if bad or not_equal:
            raise AssertionError(f"msda_q8 sampler differs from plain on {name}: {not_equal} elements "
                                 f"({bad} beyond atol {atol} rtol {rtol})")
        s_err = max(s_err, max_abs)
        k1 = ms_deform_attn(value, LEVELS, locs6, weights).float()
        attn_sum = weights.float().sum((-2, -1)).repeat_interleave(C // H, dim=-1)  # (B, Q, C)
        k1_atol, k1_rtol = TOL[torch.bfloat16]
        limit = scale * (0.5 + 127 * 2 ** -8) * attn_sum + k1_atol + k1_rtol * k1.abs()
        ratio = float(((got.float() - k1).abs() / limit).max())
        if ratio > 1:
            raise AssertionError(f"msda_q8 errs from K1 beyond the quantisation bound on {name}: {ratio:.3f}")
        in_level, nonzero, _ = corner_counts(locs6, LEVELS)
        L, P = locs5.shape[2:4]
        small = 4 * (locs5.numel() + weights.numel())
        q_bound = bound(nbytes(value, table, scale), 3 * value.numel())
        s_bound = bound(nbytes(table, scale, got) + small, 2 * nonzero * C + 2 * B * Q * L * P * C)
        q_ms = cuda_ms(lambda: q8_quantize(value), 20)
        q_plain = cuda_ms(lambda: q8_quantize_plain(value), 5)
        s_ms = cuda_ms(lambda: q8_sample(table, scale, LEVELS, locs5, weights, value.dtype), 20)
        s_plain = cuda_ms(lambda: q8_sample_plain(table, scale, LEVELS, locs5, weights, value.dtype), 3)
        both_ms = cuda_ms(lambda: ms_deform_attn_q8(value, LEVELS, locs5, weights), 20)
        both_plain = cuda_ms(lambda: ms_deform_attn_q8_plain(value, LEVELS, locs5, weights), 3)
        k1_ms = cuda_ms(lambda: ms_deform_attn(value, LEVELS, locs6, weights), 20)
        print(f"msda_q8: {name} encoder layer G=1 B={B} Q={Q} S={S} C={C} bf16; table and scale equal to plain "
              f"(differences {table_diff}); sampler max_abs_err={max_abs:.3e} (atol {atol} rtol {rtol}) "
              f"not_bit_equal={not_equal}; vs K1 max err/bound={ratio:.4f} (max |q8 - K1| "
              f"{float((got.float() - k1).abs().max()):.3e}, largest scale {float(scale.max()):.3e}); "
              f"quantise kernel_ms={q_ms:.4f} plain_ms={q_plain:.4f} bound_ms={q_bound[0]:.4f} ({q_bound[1]}); "
              f"sample kernel_ms={s_ms:.4f} plain_ms={s_plain:.4f} bound_ms={s_bound[0]:.4f} ({s_bound[1]}); "
              f"both ms={both_ms:.4f} plain_ms={both_plain:.4f}; K1 on the same inputs ms={k1_ms:.4f}; card: {smi}")
        if name == "captured serve":
            timing = ((q_ms, q_plain, *q_bound), (s_ms, s_plain, *s_bound))
        for base_dir, base in bases:
            quantize, sample, q_out, s_out = q8_launchers(value, locs5, weights)
            turns = in_turns(quantize, base, new, 20)
            print(f"q8_ab: {name} baseline={base_dir}: quantise ms base/new/new/base "
                  f"{[round(v, 4) for v in turns]} same_output={same_output(quantize, q_out, base, new)} "
                  f"bound {q_bound[0]:.4f}, share base {2 * q_bound[0] / (turns[0] + turns[3]):.3f} new "
                  f"{2 * q_bound[0] / (turns[1] + turns[2]):.3f}; sample ms base/new/new/base "
                  f"{[round(v, 4) for v in in_turns(sample, base, new, 20)]} same_output="
                  f"{same_output(sample, s_out, base, new)}; card: {smi}")
        del table, scale, want_table, want_scale, got, want, k1
    print(f"msda_q8: phase_s={time.perf_counter() - t0:.2f}")
    return s_err, timing


def phase_serve_q8(smi):
    """The flagship served with the JAX package's switch MSDA_GATHER_QUANT=int8:
    per forward 6 int8 quantise and 6 int8 sample launches (the encoder), 6
    MSDA (the decoder) and 1 grid NMS; then the timed batch's forward with
    the switch on and off in turns (int8, bf16, bf16, int8; three rounds),
    and how far the two forwards' detections differ."""
    old = os.environ.get("MSDA_GATHER_QUANT")
    os.environ["MSDA_GATHER_QUANT"] = "int8"
    try:
        launches, predictor, inputs = phase_serve(
            smi, "serve_q8", None, "flagship R50, MSDA_GATHER_QUANT=int8",
            per_forward={"msda": 6, "msda_q8_quantize": 6, "msda_q8_sample": 6})
        times, outs = {"int8": [], "none": []}, {}
        for _ in range(3):
            for mode in ("int8", "none", "none", "int8"):
                os.environ["MSDA_GATHER_QUANT"] = mode
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                outs[mode] = predictor.forward(*inputs)
                end.record()
                torch.cuda.synchronize()
                times[mode].append(start.elapsed_time(end))
    finally:
        if old is None:
            os.environ.pop("MSDA_GATHER_QUANT", None)
        else:
            os.environ["MSDA_GATHER_QUANT"] = old
    score_gap = float((outs["int8"]["scores"].float() - outs["none"]["scores"].float()).abs().max())
    same_labels = float((outs["int8"]["labels"] == outs["none"]["labels"]).float().mean())
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"serve_q8: timed batch B=4 in turns int8/bf16/bf16/int8 x3: int8 forward_ms="
          f"{[round(x, 3) for x in times['int8']]} median_ms={med['int8']:.3f}; bf16 forward_ms="
          f"{[round(x, 3) for x in times['none']]} median_ms={med['none']:.3f}; int8 vs bf16 top-300: largest "
          f"score gap {score_gap:.4e}, same label share {same_labels:.4f}; card: {smi}")
    return launches



# the tools phase: where it writes (an ignored directory of the checkout), the
# flagship request it draws on (landscape, not the canvas's size), and the
# K3 counter of the design the numerics name
TOOLS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tools"
TOOLS_REQUEST, TOOLS_CANVAS = (480, 640), (800, 1344)
CAM_LEVEL, CAM_TOP_K = 1, 5
CAM_K3_LAUNCHES = 12  # the Grad-CAM backward reaches every MSDA layer's value


def launches_of(run):
    """(run's result, the kernels it launched) with the counts set to 0
    just before it and read just after."""
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: v for k, v in native.LAUNCHES.items() if v}


def small_cam(device):
    """The small random-weight model's Grad-CAM (level 1, top 5) on two
    images, one padded, in float32, its MSDA sampling offsets moved off the
    pixel centres (the kinks) as phase 9 moves them."""
    cfg = SalienceDETRConfig(**SMALL)
    model, _ = build_salience_detr(cfg, torch.device(device), torch.Generator().manual_seed(8))
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MultiScaleDeformableAttention):
                w = m.sampling_offsets.weight
                w.copy_((torch.randn(w.shape, generator=gen) * 0.02).to(w.device))
    rng = np.random.default_rng(8)
    requests = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in ((70, 101), (96, 128))]
    images, sizes, _ = preprocess(requests, cfg, "cpu")
    cam, logits, _ = grad_cam_tool.make_cam_fn(model, CAM_LEVEL, CAM_TOP_K)(images.to(device), sizes.to(device))
    return cam.cpu(), logits.cpu()


def phase_tools(smi, device="cuda"):
    """The user tools on the flagship R50 (seed-0 weights, 800x1344, bf16
    autocast), B=1, each through the function its CLI calls:

    * benchmark_model: parameters (as the JAX tool counts them), FLOPs a
      forward by FlopCounterMode (convolutions, GEMMs, attention and the
      MSDA operator's formula), peak memory, latency (CUDA events over 20
      forwards) and img/s, and the latency again with the process's objects
      frozen out of Python's collector, beside what the process held before
      the tool (threads, tracked objects, allocated bytes);
    * export with --with-postprocess: ``torch.export`` of the uint8-canvas
      -> detections program, saved and loaded, its graph's kernel operators
      listed (the MSDA and grid-NMS operators must be there); the loaded
      program against the live model on seeded pixels at rtol 1e-3 / atol
      1e-5, with 12 K1 and 1 K2 launches counted inside it; then
      ``ExportedDetector`` on a TOOLS_REQUEST image against ``Predictor``
      (the same letterbox, forward and post-process) at the same bounds;
    * the salience maps (feature_viz) and the Grad-CAM (level 1, top 5) of
      that image: 12 K1 and 1 K2 launches for the maps; 12 K1, 1 K2 and 12
      K3 (the design the numerics name) for the CAM; the CAM finite and not
      all zero;
    * the small model's CAM on the card against the CPU's (float32, TF32
      off): each image's within 1e-3 of that image's largest value (the
      bound of the CPU test against the JAX tool), and the same logits at
      rtol 1e-3 / atol 1e-3;
    * the inference CLI with --show-dir refusing by name where cv2 is
      missing (cv2 is blocked from import here), launching nothing.

    ``device`` "cpu" rehearses the phase (with ``torch.cuda.synchronize``
    stubbed, a tiny ``DEFAULT_CONFIG`` and ``TOOLS_CANVAS``)."""
    H, W = TOOLS_CANVAS
    t0 = time.perf_counter()
    if TOOLS_DIR.exists():
        import shutil

        shutil.rmtree(TOOLS_DIR)
    TOOLS_DIR.mkdir(parents=True)
    cfg = load_config(DEFAULT_CONFIG)
    served = Predictor(cfg, None, device, seed=0)
    model, post = served.model, served.postprocess

    # what the process holds before the tool runs: the forward is host-bound,
    # so its latency follows the host's state as well as the card's
    allocated = torch.cuda.memory_allocated() / 2**30 if device == "cuda" else 0.0
    host = (f"{threading.active_count()} Python threads, {len(gc.get_objects())} objects tracked by the "
            f"collector, {allocated:.3f} GiB allocated")
    bench = bench_tool.benchmark(model, cfg, 1, H, W, repeats=20)
    gc.freeze()  # the same forwards with the process's objects out of the collector's scans
    try:
        frozen_ms = bench_tool.benchmark(model, cfg, 1, H, W, repeats=20)["ms"]
    finally:
        gc.unfreeze()
    flops = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in bench["flops"].items() if k != "total")
    peak = "not measured" if bench["peak_bytes"] is None else f"{bench['peak_bytes'] / 2**30:.3f} GiB"
    print(f"tools_benchmark: flagship R50 B=1 {H}x{W} {cfg.dtype}: params {bench['params']} "
          f"({bench['params'] / 1e6:.2f} M); {bench['flops']['total'] / 1e9:.3f} GFLOPs a forward "
          f"(FlopCounterMode: {flops} GFLOPs; element-wise ops, norms, sorts, the grid NMS and the bilinear "
          f"weights not counted); peak {peak}; latency {bench['ms']:.3f} ms ({bench['img_per_s']:.2f} img/s, "
          f"CUDA events over 20 forwards), {frozen_ms:.3f} ms again with gc.freeze(); before the tool the process "
          f"held {host}; card: {smi}")

    t1 = time.perf_counter()
    program = export_tool.export_detector(model, post, cfg, 1, H, W, with_postprocess=True)
    export_s = time.perf_counter() - t1
    path = TOOLS_DIR / "flagship_postprocess.pt2"
    torch.export.save(program, str(path))
    loaded = torch.export.load(str(path))
    ops = export_tool.kernel_ops(loaded)
    autocast_region = any("autocast" in t for t in export_tool.call_targets(loaded))
    inputs = export_tool.example_inputs(1, H, W, True, torch.device(device), seed=1)
    with torch.no_grad():
        got, program_launches = launches_of(lambda: loaded.module()(*inputs))
        want = export_tool.DetectorProgram(model, post, cfg, True)(*inputs)
    gaps = export_tool.largest_gaps(got, want)
    image = np.random.default_rng(17).integers(0, 256, size=(*TOOLS_REQUEST, 3), dtype=np.uint8)
    detector = export_tool.ExportedDetector(loaded, cfg.min_size, cfg.max_size)
    by_program, by_predictor = detector.detect([image]), served([image])[0]
    serve_gaps = export_tool.largest_gaps({k: torch.from_numpy(v[0]) for k, v in by_program.items()},
                                          {k: v.cpu() for k, v in by_predictor.items()})
    print(f"tools_export: flagship R50 --with-postprocess B=1 {H}x{W} in {export_s:.1f} s ({cfg.dtype} under "
          f"autocast: autocast region in the graph {autocast_region}); {path.stat().st_size / 2**20:.1f} MiB "
          f"saved; kernel operators in the graph {ops}; launches inside the loaded program {program_launches}; "
          f"loaded program vs live model largest |d| - 1e-3 |want| {gaps} (atol 1e-5); ExportedDetector vs "
          f"Predictor on a {TOOLS_REQUEST[0]}x{TOOLS_REQUEST[1]} image {serve_gaps}")
    wanted_ops = {"salience_detr.ms_deform_attn.default", "salience_detr.grid_nms_topk.default"}
    if (not wanted_ops <= set(ops) or program_launches != EVAL_FORWARD_KERNELS
            or not all(g <= export_tool.ATOL for g in list(gaps.values()) + list(serve_gaps.values()))):
        raise AssertionError("tools: the exported program lacks a kernel operator, launched other kernels or "
                             "differs from the live model (tools_export line)")
    del program, loaded, detector
    torch.cuda.empty_cache()

    images, sizes, _ = preprocess([image], cfg, device)
    maps, map_launches = launches_of(lambda: feature_viz_tool.salience_maps(model, cfg, images, sizes))
    cam_fn = grad_cam_tool.make_cam_fn(model, CAM_LEVEL, CAM_TOP_K, cfg)
    (cam, logits, _), cam_launches = launches_of(lambda: cam_fn(images, sizes))
    k3 = "msda_backward" if backward_design() == "scatter" else "msda_backward_ordered"
    cam_ok = bool(torch.isfinite(cam).all()) and float(cam.abs().max()) > 0
    print(f"tools_maps: salience maps {[tuple(m.shape) for m in maps]} launches {map_launches}; Grad-CAM level "
          f"{CAM_LEVEL} top {CAM_TOP_K}: cam {tuple(cam.shape)} max {float(cam.max()):.4e} nonzero share "
          f"{float((cam > 0).float().mean()):.4f} finite {bool(torch.isfinite(cam).all())}, launches {cam_launches} "
          f"(K3 design {backward_design()})")
    cam_expected = {k: v for k, v in {**EVAL_FORWARD_KERNELS, k3: CAM_K3_LAUNCHES}.items() if v}
    if (map_launches != EVAL_FORWARD_KERNELS or cam_launches != cam_expected or not cam_ok
            or not all(bool(torch.isfinite(m).all()) for m in maps)):
        raise AssertionError("tools: the salience maps or the Grad-CAM launched other kernels or are not finite "
                             "and nonzero (tools_maps line)")
    del model, post, served, cam_fn
    torch.cuda.empty_cache()

    (cam_card, logits_card), (cam_cpu, logits_cpu) = small_cam(device), small_cam("cpu")
    cam_scales = cam_cpu.flatten(1).abs().amax(1)
    cam_ratio = float(((cam_card - cam_cpu).flatten(1).abs().amax(1) / (1e-3 * cam_scales)).max())
    logits_ok = torch.allclose(logits_card, logits_cpu, rtol=1e-3, atol=1e-3)
    print(f"tools_cam_small: small float32 Grad-CAM card-vs-cpu cam max {float(cam_cpu.max()):.4e}, "
          f"err/bound {cam_ratio:.3e} (bound 1e-3*max|cam| an image), logits max abs err "
          f"{float((logits_card - logits_cpu).abs().max()):.3e} (rtol 1e-3, atol 1e-3)")
    if not bool((cam_scales > 0).all()) or cam_ratio > 1.0 or not logits_ok:
        raise AssertionError("tools: the small model's Grad-CAM on the card disagrees with the CPU's")

    real_cv2 = sys.modules.get("cv2")
    sys.modules["cv2"] = None  # import cv2 raises ImportError, as where it is not installed
    try:
        refused, refusal_launches = launches_of(lambda: refusal_of(["--image-dir", str(TOOLS_DIR), "--show-dir",
                                                                     str(TOOLS_DIR / "shown")]))
    finally:
        if real_cv2 is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = real_cv2
    print(f"tools_show_dir: inference --show-dir without cv2: {refused!r}, launches {refusal_launches}; "
          f"tools phase {time.perf_counter() - t0:.1f} s")
    if "cv2" not in refused or refusal_launches:
        raise AssertionError("tools: the inference CLI's --show-dir did not refuse by name without cv2")


def refusal_of(argv) -> str:
    """The error the inference CLI raises on ``argv``, or "no error"."""
    from salience_detr_torch import inference as inference_cli

    try:
        inference_cli.main(argv)
    except RuntimeError as e:
        return str(e)
    return "no error"

# slice 10: the backbone families.  Small archs registered in the port's
# tables for the card-vs-CPU slices (stochastic depth 0, so that the two
# devices run the same function), and the configs served and trained at
# full width and depth
SMALL_ARCHS = {
    (resnet_bb, "resnext_smoke"): dict(block="bottleneck", layers=(1, 1, 1, 1), width=4, groups=8),
    (convnext_bb, "conv_smoke"): dict(depths=(1, 1, 2, 1), dims=(32, 64, 96, 128), sd=0.0),
    (swin_bb, "swin_smoke"): dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window=7, sd=0.0),
    (swin_bb, "swin_v2_smoke"): dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window=7,
                                     sd=0.0, v2=True),
    (focalnet_bb, "focalnet_smoke"): dict(embed_dim=32, depths=(1, 1, 2, 1), focal_levels=(3,) * 4,
                                          focal_windows=(3,) * 4, conv_embed=True, postln=True, layerscale=True,
                                          norm_mod=True, sd=0.0),
    (vit_bb, "vit_smoke"): dict(embed_dim=64, depth=2, num_heads=2, window=4, global_idx=(1,), pos_grid=14),
    (vit_bb, "eva_02_smoke"): dict(embed_dim=64, depth=2, num_heads=2, mlp_dim=96, window=4, window_idx=(0,),
                                   rope=True, swiglu=True, drop_path=0.0, pos_grid=14),
}
CONFIG_DIR = Path(__file__).resolve().parent / "configs" / "salience_detr_torch"
BACKBONE_CONFIGS = {
    "swin_l": ("salience_detr_swin_l_800_1333.py", "Swin-L"),
    "convnext_l": ("salience_detr_convnext_l_800_1333.py", "ConvNeXt-L"),
    "focalnet_l": ("salience_detr_focalnet_large_lrf_800_1333.py", "FocalNet-L (lrf, 4 focal levels)"),
    "r50_5scale": ("salience_detr_resnet50_5scale_800_1333.py", "R50 5-scale (strides 4-32, S=89250)"),
}
EVA02_BACKBONE = "eva_02_vit_b_4attn_1024"
# the 5-scale levels of the 800x1344 canvas (S = 89,250, the rank map fits K2's
# shared memory) and of a 1344x1344 canvas (S = 149,940, it does not)
FIVE_SCALE_LEVELS = [(200, 336), (100, 168), (50, 84), (25, 42)]
FIVE_SCALE_SQUARE = [(336, 336), (168, 168), (84, 84), (42, 42)]


def backbone_config(name):
    if name == "eva02_b":  # no shipped config: the flagship with the EVA-02-B backbone
        return dataclasses.replace(load_config(DEFAULT_CONFIG), backbone=EVA02_BACKBONE), "EVA-02-B (flagship)"
    path, label = BACKBONE_CONFIGS[name]
    return load_config(CONFIG_DIR / path), label


def phase_msda_backbone_shapes(smi):
    """K1 and K3 at the shapes this slice's configs give them: the inputs of
    encoder layer 0 (exact per-head sampling, G=8) and decoder layer 0 (G=8,
    Q=1100) of one train step at init, of the R50 5-scale config (strides
    4-32, S=89,250) and of the Swin-L config (strides 8-64, S=22,323):
    against the plain versions at the tolerances of phases 3 and 7, with
    times and bounds."""
    t0 = time.perf_counter()
    out = {}
    for name, levels in (("r50_5scale", FIVE_SCALE_LEVELS), ("swin_l", LEVELS)):
        cfg, label = backbone_config(name)
        captured = capture_train_inputs(cfg, levels)
        del captured["assignment"]
        S = sum(h * w for h, w in levels)
        for layer in ("encoder", "decoder"):
            c = captured[layer]
            value, locs, weights, d_out = c["value"], c["locations"], c["weights"], c["d_out"]
            G, Q, dtype = locs.shape[2], locs.shape[1], value.dtype
            if G != cfg.num_heads:
                raise AssertionError(f"{name} {layer}: G={G}, the config samples per head")
            got, want = ms_deform_attn(value, levels, locs, weights), ms_deform_attn_plain(value, levels, locs, weights)
            torch.cuda.synchronize()
            max_abs, _, bad, atol, rtol = compare(got, want, dtype)
            if bad:
                raise AssertionError(f"msda kernel disagrees with plain on {name} {layer}: {bad} elements")
            bwd_err, _ = backward_checks(value, locs, weights, d_out, f"{name} {layer}", levels)
            fwd_ms = cuda_ms(lambda: ms_deform_attn(value, levels, locs, weights), 20)
            fwd_plain = cuda_ms(lambda: ms_deform_attn_plain(value, levels, locs, weights), 3)
            bwd_ms = cuda_ms(lambda: _backward_cuda(value, levels, locs, weights, d_out), 10)
            bwd_plain = cuda_ms(lambda: ms_deform_attn_backward_plain(value, levels, locs, weights, d_out), 2)
            (fb, fby), (bb, bby) = msda_bounds(value, locs, weights, levels)
            out[f"{name} {layer}"] = (fwd_ms, bwd_ms)
            print(f"msda_backbone_shapes: {label} {layer} layer 0 of a train step at init, G={G} "
                  f"B={locs.shape[0]} Q={Q} S={S} value {str(dtype)[6:]}: K1 max_abs_err={max_abs:.3e} "
                  f"(atol {atol} rtol {rtol}) kernel_ms={fwd_ms:.4f} plain_ms={fwd_plain:.4f} bound_ms={fb:.4f} "
                  f"({fby}); K3 max_abs_err={bwd_err:.3e} kernel_ms={bwd_ms:.4f} plain_ms={bwd_plain:.4f} "
                  f"bound_ms={bb:.4f} ({bby}); card: {smi}")
        del captured
        torch.cuda.empty_cache()
    print(f"msda_backbone_shapes: phase_s={time.perf_counter() - t0:.2f}")
    return out


NUMERICS_TIMED = 5  # numerics_cost: timed steps or forwards a turn, after one untimed


def torch_default_numerics():
    """PyTorch's own settings for what ``configure_numerics`` sets: cuDNN's
    attention on, TF32 in cuDNN's convolutions, none in cuBLAS, no cuDNN
    benchmark."""
    torch.backends.cuda.enable_cudnn_sdp(True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


NUMERICS_SETTINGS = {
    # what a CLI process runs: PyTorch's defaults, then configure_numerics
    "cli": lambda: (torch_default_numerics(), configure_numerics()),
    # the checks' setting: also no TF32
    "exact": lambda: configure_numerics(exact_float32=True),
    "default": torch_default_numerics,
}


def phase_numerics_cost(smi):
    """What ``utils.env.configure_numerics`` costs on the flagship: a bf16
    and a float32 ``Trainer`` step and a bf16 eval forward
    (``Predictor.forward``, B=4) as a CLI process computes them (cuDNN's
    attention off, C-26's repair), with TF32 off as well (the checks'
    ``exact_float32``), and under PyTorch's defaults, in turns (cli, exact,
    default, default, exact, cli), each turn the device-time median of
    NUMERICS_TIMED after one untimed."""
    t0 = time.perf_counter()
    order = ("cli", "exact", "default", "default", "exact", "cli")
    medians = {}
    try:
        for label, dtype in (("train bf16", torch.bfloat16), ("train f32", torch.float32)):
            trainer = Trainer(ddp_flagship(dtype), "cuda", seed=0, steps_per_epoch=100)
            batch = next(trainer.batches(1, seed=0))
            turns = []
            for setting in order:
                NUMERICS_SETTINGS[setting]()
                turns.append(statistics.median(cuda_times(lambda: trainer.step(batch, trainer.generator),
                                                          NUMERICS_TIMED)))
            medians[label] = turns
            del trainer, batch
            torch.cuda.empty_cache()
        predictor = Predictor(load_config(DEFAULT_CONFIG), None, "cuda", seed=0)
        inputs = preprocess(make_requests(TIMED_BATCH, 7), predictor.cfg, "cuda")
        turns = []
        for setting in order:
            NUMERICS_SETTINGS[setting]()
            turns.append(statistics.median(cuda_times(lambda: predictor.forward(*inputs), NUMERICS_TIMED)))
        medians["eval forward bf16"] = turns
    finally:
        NUMERICS_SETTINGS["exact"]()  # this script's own setting
    parts = []
    for label, turns in medians.items():
        mean = {k: statistics.mean(t for t, o in zip(turns, order) if o == k) for k in NUMERICS_SETTINGS}
        parts.append(f"{label} ms {'/'.join(order)} {[round(t, 3) for t in turns]} (over default: cli "
                     f"{mean['cli'] / mean['default']:.4f}, exact {mean['exact'] / mean['default']:.4f})")
    print(f"numerics_cost: flagship R50, device ms (median of {NUMERICS_TIMED} a turn): {'; '.join(parts)}; "
          f"phase_s={time.perf_counter() - t0:.2f}; card: {smi}")


E2E_TIMED = 5  # steps_e2e: timed steps or forwards a reading, after one untimed
E2E_KERNELS = ("msda_backward", "msda_backward_ordered", "deform_conv_fused", "deform_conv", "deform_conv_backward")


def phase_steps_e2e(smi):
    """End-to-end readings beside K3's and B6's kernel times, each the
    median of E2E_TIMED calls after one untimed between CUDA events (these
    host-bound calls keep the card idle between launches, so the events
    read mostly the host) and the card's busy time a call (the sum of its
    kernels' device times over 2 profiled calls, ``kernel_breakdown``):
    a ``Trainer`` step (B=4, bf16 autocast, gts GT_COUNTS) of the flagship
    and of the R50 5-scale config with the train CLI's
    ``--use-deterministic-algorithms`` numerics (K3's ordered design), then
    an R50-DCN ``Predictor.forward`` (B=4, the timed serve batch) and train
    step, their offset and mask convs at seeded small normals; with the
    kernel launches of one timed call each.  Only ``Trainer``,
    ``Predictor`` and the phases' helpers are used, so the same phase times
    an earlier commit's package from its own checkout."""
    t0 = time.perf_counter()
    parts = []

    def reading(label, fn):
        before = dict(native.LAUNCHES)
        fn()
        torch.cuda.synchronize()
        counted = {k: native.LAUNCHES[k] - before[k] for k in E2E_KERNELS if native.LAUNCHES[k] != before[k]}
        times = cuda_times(fn, E2E_TIMED)
        busy = sum(kernel_breakdown(fn, iters=2).values())
        parts.append(f"{label} median_ms={statistics.median(times):.3f} ms={[round(x, 3) for x in times]} "
                     f"device_busy_ms={busy:.3f} launches a call {counted}")

    try:
        configure_numerics(deterministic=True)
        for name, cfg in (("flagship", load_config(DEFAULT_CONFIG)), ("R50 5-scale", backbone_config("r50_5scale")[0])):
            trainer = Trainer(cfg, "cuda", seed=0, steps_per_epoch=100)
            batch = next(trainer.batches(1, seed=0, counts=GT_COUNTS))
            reading(f"{name} train step, deterministic", lambda: trainer.step(batch, trainer.generator))
            del trainer, batch
            torch.cuda.empty_cache()
    finally:
        configure_numerics(exact_float32=True)  # this script's own setting
    torch.use_deterministic_algorithms(False)
    predictor = Predictor(load_config(DCN_CONFIG), None, "cuda", seed=0)
    offsets_off_grid(predictor.model)
    inputs = preprocess(make_requests(TIMED_BATCH, 7), predictor.cfg, "cuda")
    reading("R50-DCN serve forward", lambda: predictor.forward(*inputs))
    # the 16-bit layers' two routes in turns: as shipped, then every layer
    # through the columns kernel + torch.matmul
    shipped = dcn_ops.FUSED_MAX_F
    try:
        for label, max_f in (("route", shipped), ("columns", 0), ("columns", 0), ("route", shipped)):
            dcn_ops.FUSED_MAX_F = max_f
            reading(f"R50-DCN serve forward, {label} (FUSED_MAX_F={max_f})", lambda: predictor.forward(*inputs))
    finally:
        dcn_ops.FUSED_MAX_F = shipped
    del predictor, inputs
    trainer = Trainer(load_config(DCN_CONFIG), "cuda", seed=0, steps_per_epoch=100)
    offsets_off_grid(trainer.model)
    batch = next(trainer.batches(1, seed=0, counts=GT_COUNTS))
    reading("R50-DCN train step", lambda: trainer.step(batch, trainer.generator))
    del trainer, batch
    torch.cuda.empty_cache()
    print(f"steps_e2e: {'; '.join(parts)}; phase_s={time.perf_counter() - t0:.2f}; card: {smi}")


def k3_launchers(value, locs, weights, d_out, levels=LEVELS):
    """Launch-only calls of both K3 designs of a given library on these
    inputs (locations and weights cast to f32 once, outputs allocated once,
    the ordered design's workspace once a library, from that library's
    size), this build's workspace bytes, and the ordered design's outputs
    (d_value, d_locations, d_weights), which every ordered call rewrites."""
    B, S, C = value.shape
    Q, G = locs.shape[1:3]
    H, P = weights.shape[2], weights.shape[-1]
    loc32, attn32 = locs.float().contiguous(), weights.float().contiguous()
    d_value32 = torch.zeros(B, S, C, device=value.device)
    d_value = torch.empty(B, S, C, dtype=value.dtype, device=value.device)
    d_loc, d_attn = torch.empty_like(loc32), torch.empty_like(attn32)
    table, bf16, stream = native.level_table(levels), int(value.dtype == torch.bfloat16), native.stream_of(value)
    workspaces = {}

    def workspace(lib):
        if id(lib) not in workspaces:
            size = lib.msda_backward_workspace(table, B, S, Q, C, H, G, P)
            workspaces[id(lib)] = torch.empty(size, dtype=torch.uint8, device=value.device)
        return workspaces[id(lib)]

    def scatter(lib):  # d_value keeps accumulating: the same atomics each call
        native.check(lib.msda_backward(value.data_ptr(), bf16, table, loc32.data_ptr(), attn32.data_ptr(),
                                       d_out.data_ptr(), d_value32.data_ptr(), d_loc.data_ptr(),
                                       d_attn.data_ptr(), B, S, Q, C, H, G, P, stream), "msda_backward")

    def ordered(lib):
        native.check(lib.msda_backward_ordered(value.data_ptr(), bf16, table, loc32.data_ptr(), attn32.data_ptr(),
                                               d_out.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
                                               d_attn.data_ptr(), workspace(lib).data_ptr(), B, S, Q, C, H, G,
                                               P, stream), "msda_backward_ordered")

    return scatter, ordered, workspace(native.load()).numel(), (d_value, d_loc, d_attn)


def same_ordered_outputs(ordered, outputs, base, new):
    """Whether a baseline library's ordered design writes the bits this
    build's does (d_value, d_locations, d_weights), each equal or not."""
    ordered(new)
    torch.cuda.synchronize()
    mine = [t.clone() for t in outputs]
    ordered(base)
    torch.cuda.synchronize()
    return [torch.equal(a, b) for a, b in zip(mine, outputs)]


def ordered_bound(value, locs, weights, levels):
    """The ordered K3's bound: the function's own bytes and operations, as
    ``msda_bounds`` counts K3's, with d_value written in the value dtype.
    The entries' workspace is the design's, not the function's: its bytes
    are reported beside the bound (``workspace_ms``), never in it."""
    B, S, C = value.shape
    in_level, nonzero, _ = corner_counts(locs, levels)
    small = 4 * (locs.numel() + weights.numel())
    out = B * locs.shape[1] * C * value.element_size()
    return bound(nbytes(value) + out + 2 * small + B * S * C * value.element_size(),
                 2 * (in_level + nonzero) * (C // locs.shape[2]))


def workspace_ms(workspace_bytes):
    """What the ordered K3's workspace would cost at the card's memory rate,
    each byte written once and read once."""
    return 2 * workspace_bytes / HBM_BYTES_PER_MS


def kernel_breakdown(fn, iters=3):
    """Device ms of each kernel (by name, shortened) per call of ``fn``,
    from a torch.profiler trace of ``iters`` calls (device tracing only)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
            by_name[re.split(r"[<(]", name)[0][:48]] += e.time_range.elapsed_us() / 1e3 / iters
    return {k: round(v, 4) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}


def ordered_checks(label, value, locs, weights, d_out, levels, baselines, smi):
    """The ordered K3 on one input set: against the plain backward at K3's
    tolerances, two launches bitwise equal (d_value, d_locations,
    d_weights), through autograd under ``torch.use_deterministic_algorithms``
    (counted under its own key), and timed in turns with the scatter design
    (launch only and with the wrappers; with ``baselines``, also against
    each directory's scatter K3, and each directory's ordered design held
    bitwise equal to this one and timed in turns with it, with its time by
    kernel beside this one's).  Returns (largest error, (ms, plain ms,
    bound ms, bound by), launch-only ms of both designs)."""
    first = _backward_cuda_ordered(value, levels, locs, weights, d_out)
    second = _backward_cuda_ordered(value, levels, locs, weights, d_out)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    if not all(same):
        raise AssertionError(f"msda_ordered {label}: two launches differ (d_value, d_loc, d_attn equal: {same})")
    plain = ms_deform_attn_backward_plain(value, levels, locs, weights, d_out)
    worst, parts = 0.0, []
    for name, got, want in zip(("d_value", "d_locations", "d_weights"), first, plain):
        max_abs, scale, bad, atol_rel, rtol = compare_bwd(got, want)
        parts.append(f"{name}={max_abs:.3e}(max|ref| {scale:.3e}, violations {bad})")
        if bad or got.dtype != want.dtype:
            raise AssertionError(f"msda_ordered {label}: {name} disagrees with the plain backward: {bad} elements, "
                                 f"dtype {got.dtype}")
        worst = max(worst, max_abs)
    del plain
    inputs = [x.clone().requires_grad_() for x in (value, locs, weights)]
    before = dict(native.LAUNCHES)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        if backward_design() != "ordered":
            raise AssertionError(f"msda_ordered: the design under deterministic algorithms is {backward_design()}")
        ms_deform_attn(inputs[0], levels, inputs[1], inputs[2]).backward(d_out)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    counted = {k: native.LAUNCHES[k] - before[k] for k in ("msda_backward", "msda_backward_ordered")}
    if counted != {"msda_backward": 0, "msda_backward_ordered": 1} or not all(
            torch.equal(x.grad, g) for x, g in zip(inputs, first)):
        raise AssertionError(f"msda_ordered {label}: autograd launched {counted} or differs from the wrapper")
    del inputs, first, second
    scatter, ordered, workspace_bytes, outputs = k3_launchers(value, locs, weights, d_out, levels)
    lib = native.load()
    launch = [cuda_ms(lambda: run(lib), 10) for run in (scatter, ordered, ordered, scatter)]
    wrapped = [cuda_ms(lambda: fn(value, levels, locs, weights, d_out), 10)
               for fn in (_backward_cuda, _backward_cuda_ordered, _backward_cuda_ordered, _backward_cuda)]
    bb, bby = ordered_bound(value, locs, weights, levels)
    by_kernel = kernel_breakdown(lambda: ordered(lib))
    base_parts = []
    for base_dir in baselines:
        base = baseline_library(base_dir)
        if hasattr(base, "msda_backward"):
            turns = [cuda_ms(lambda: run(lib_), 10) for run, lib_ in
                     ((scatter, base), (ordered, lib), (ordered, lib), (scatter, base))]
            base_parts.append(f"against {base_dir}'s scatter K3 base/ordered/ordered/base "
                              f"{[round(x, 4) for x in turns]}")
        if hasattr(base, "msda_backward_ordered"):
            same = same_ordered_outputs(ordered, outputs, base, lib)
            if not all(same):
                raise AssertionError(f"msda_ordered {label}: the ordered design differs from {base_dir}'s "
                                     f"(d_value, d_loc, d_attn bitwise equal: {same})")
            turns = [cuda_ms(lambda: ordered(lib_), 10) for lib_ in (base, lib, lib, base)]
            base_parts.append(f"against {base_dir}'s ordered K3 (bitwise equal) base/new/new/base "
                              f"{[round(x, 4) for x in turns]}, its launch by kernel (profiler) "
                              f"{kernel_breakdown(lambda: ordered(base))}")
    print(f"msda_ordered: {label} G={locs.shape[2]} B={value.shape[0]} Q={locs.shape[1]} S={value.shape[1]} "
          f"{str(value.dtype)[6:]}: errors against the plain backward {' '.join(parts)}; two launches bitwise "
          f"equal; launch-only ms scatter/ordered/ordered/scatter {[round(x, 4) for x in launch]}; with the "
          f"wrappers {[round(x, 4) for x in wrapped]}; {'; '.join(base_parts) + '; ' if base_parts else ''}"
          f"ordered launch by kernel (profiler) {by_kernel}; "
          f"bound_ms={bb:.4f} ({bby}); workspace {workspace_bytes / 2**20:.1f} MiB, written and read once "
          f"{workspace_ms(workspace_bytes):.4f} ms at the memory rate (not in the bound); "
          f"card: {smi}")
    return worst, (statistics.mean(wrapped[1:3]), bb, bby), (statistics.mean(launch[::3]), statistics.mean(launch[1:3]))


def phase_msda_ordered(smi, captured=None, baselines=()):
    """K3's ordered design (no float atomics) against the plain backward at
    K3's tolerances, bitwise repeatable, and timed in turns with the scatter
    design, on the inputs the flagship train step gives K3 (encoder layer 0,
    G=1 Q=11403, and decoder layer 0, G=8 Q=1100, ``captured`` or captured
    here), those of the R50 5-scale config's train step (exact G=8 encoder,
    Q=45,570, S=89,250) and the Swin-L config's (exact G=8 encoder, Q=11,403)
    and uniform inputs.  Returns the kernels line's
    (error, timing) on the captured flagship encoder, with the plain
    version's ms there."""
    t0 = time.perf_counter()
    captured = captured or capture_train_inputs()
    sets = [(f"captured flagship {name}", captured[name], LEVELS) for name in ("encoder", "decoder")]
    for config, label, levels in (("r50_5scale", "5-scale", FIVE_SCALE_LEVELS), ("swin_l", "Swin-L", LEVELS)):
        train_inputs = capture_train_inputs(backbone_config(config)[0], levels)
        sets += [(f"captured {label} {name}", train_inputs[name], levels) for name in ("encoder", "decoder")]
        del train_inputs
    gen = torch.Generator(device="cuda").manual_seed(16)
    for G, Q in ((1, 11403), (8, 1100)):
        value32, locs, weights = uniform_msda_inputs(gen, G, Q)
        d_out32 = torch.randn(value32.shape[0], Q, value32.shape[2], generator=gen, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            sets.append((f"uniform {str(dtype)[6:]}", {"value": value32.to(dtype), "locations": locs,
                                                       "weights": weights, "d_out": d_out32.to(dtype)}, LEVELS))
    worst, result = 0.0, None
    for label, c, levels in sets:
        value, locs, weights, d_out = c["value"], c["locations"], c["weights"], c["d_out"]
        err, timing, _ = ordered_checks(label, value, locs, weights, d_out, levels, baselines, smi)
        worst = max(worst, err)
        if label == "captured flagship encoder":
            plain_ms = cuda_ms(lambda: ms_deform_attn_backward_plain(value, levels, locs, weights, d_out), 3)
            result = (timing[0], plain_ms, *timing[1:])
    del sets
    torch.cuda.empty_cache()
    print(f"msda_ordered: phase_s={time.perf_counter() - t0:.2f}")
    return worst, result


def phase_train_repeat(smi):
    """A one-process flagship train step (``Trainer``, B=4, 800x1344, the
    synthetic batch of phase train) with ``--use-deterministic-algorithms``'
    numerics (``utils.env.configure_numerics(True)``) in processes of their
    own (``salience_detr_torch.tools.repeat_check train``; the setting is
    global): float32 twice in one process, bf16 twice in one process and
    once in another.  The losses, every gradient and every parameter after
    the step must be bitwise equal within each dtype; prints the library ops
    that ``torch.use_deterministic_algorithms`` warned about."""
    t0 = time.perf_counter()
    root = DDP_DIR / "repeat"
    root.mkdir(parents=True, exist_ok=True)
    facts = []
    for dtype, runs in (("f32", (2,)), ("bf16", (2, 1))):
        outs = [root / f"train_{dtype}_{i}.json" for i in range(len(runs))]
        for out, n in zip(outs, runs):
            run_cli(["-m", "salience_detr_torch.tools.repeat_check", "train", "--deterministic", "--dtype", dtype,
                     "--runs", str(n), "--out", str(out)])
        proc = subprocess.run([sys.executable, "-m", "salience_detr_torch.tools.repeat_check", "compare",
                               *map(str, outs)], cwd=str(Path(__file__).resolve().parent), capture_output=True,
                              text=True)
        records = [json.loads(out.read_text()) for out in outs]
        if proc.returncode != 0 or any(r["design"] != "ordered" for r in records):
            raise AssertionError(f"train_repeat {dtype}: designs {[r['design'] for r in records]}; ops warned "
                                 f"about {sorted({w for r in records for w in r['warnings']})}; "
                                 f"{proc.stdout[-6000:]}")
        a = records[0]["runs"][0]
        facts.append(f"{dtype} ({sum(runs)} runs in {len(runs)} processes): loss {a['metrics']['loss']!r}, "
                     f"grad_norm {a['metrics']['grad_norm']!r}, {len(a['grads'])} gradients and "
                     f"{len(a['params'])} parameters bitwise equal; ops warned about "
                     f"{sorted({w for r in records for w in r['warnings']})}")
    print(f"train_repeat: flagship Trainer step with --use-deterministic-algorithms (the ordered K3): "
          f"{'; '.join(facts)}; phase_s={time.perf_counter() - t0:.2f}; card: {smi}")


def phase_backbone_slice():
    """Each backbone family in a small random-weight model, float32, card
    (kernels) against CPU (plain versions): the forward as phase 5 does
    (ResNeXt, ConvNeXt, Swin v1, Swin v2, FocalNet, ViT, EVA-02), one train
    step of the small Swin model as phase 9 does, and ``DropPath`` on the
    card (whole rows zeroed, the rest scaled by 1 / keep, one draw per
    generator state)."""
    t0 = time.perf_counter()
    for (module, name), arch in SMALL_ARCHS.items():
        module.ARCH_SETTINGS[name] = arch
    for _, name in SMALL_ARCHS:
        phase_slice(f"backbone_slice[{name}]", fields=dict(backbone=name))
    phase_train_slice("backbone_slice[swin_smoke train step]", fields=dict(backbone="swin_smoke"))

    dev = torch.device("cuda")
    x = torch.rand(64, 32, 10, 12, device=dev) + 1.0
    layer = DropPath(0.25).train()
    layer.generator = torch.Generator(device=dev).manual_seed(5)
    y = layer(x)
    layer.generator = torch.Generator(device=dev).manual_seed(5)
    again = layer(x)
    ratio = (y / x).reshape(64, -1)
    dropped = (ratio == 0).all(1)
    scaled = ((ratio - 1 / 0.75).abs() <= 1e-6).all(1)
    ok = bool((dropped | scaled).all()) and torch.equal(y, again) and 0 < int(dropped.sum()) < 64 and \
        torch.equal(layer.eval()(x), x)
    print(f"backbone_slice: DropPath(0.25) on the card: rows dropped {int(dropped.sum())}/64, the rest scaled by "
          f"1/keep {int(scaled.sum())}/64, same draw from the same generator state {torch.equal(y, again)}, "
          f"eval identity; phase_s={time.perf_counter() - t0:.2f}")
    if not ok:
        raise AssertionError("backbone_slice: DropPath on the card is not per-row stochastic depth")


def phase_backbone_serve(smi, name):
    """A backbone config through ``Predictor`` as phase 6: per forward 12
    MSDA and 1 grid-NMS launch, identical reruns, timed forwards and peak
    memory."""
    cfg, label = backbone_config(name)
    t0 = time.perf_counter()
    launches, predictor, inputs = phase_serve(smi, f"serve_{name}", cfg, label)
    del predictor, inputs
    torch.cuda.empty_cache()
    print(f"serve_{name}: phase_s={time.perf_counter() - t0:.2f}")
    return launches


def phase_backbone_train(smi, name, counts=GT_COUNTS):
    """A shipped backbone config through ``Trainer`` as phase 10, a warm-up
    and 2 timed steps: per step 12 MSDA forward and backward, 1 grid-NMS and
    1 assignment launch; losses finite; every trainable backbone parameter
    moves; peak memory."""
    cfg, label = backbone_config(name)
    t0 = time.perf_counter()
    launches = phase_train(smi, f"train_{name}", cfg, label, must_move=("backbone.",), timed=2, counts=counts,
                           sub_ulp_ok=True)
    torch.cuda.empty_cache()
    print(f"train_{name}: phase_s={time.perf_counter() - t0:.2f}")
    return launches


def phase_eval_swin(smi):
    """The evaluation entry point (salience_detr_torch.test.main) on the
    Swin-L config in exact mode (--torch-checkpoint) over the eval phase's
    split: a seed-1 Swin-L state dict saved with the attention buffers an
    upstream Swin checkpoint carries (``relative_position_index``), which
    the loader drops by name before its strict load.  Per forward 12 MSDA and
    1 grid-NMS launch; the 12 stats finite."""
    t0 = time.perf_counter()
    img_dir, ann = write_eval_split(EVAL_DIR)
    cfg_path = CONFIG_DIR / BACKBONE_CONFIGS["swin_l"][0]
    cfg = load_config(cfg_path)
    model, _ = build_salience_detr(cfg, torch.device("cuda"), torch.Generator().manual_seed(1))
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    buffers = {k: v.cpu() for k, v in model.named_buffers() if k.endswith("relative_position_index")}
    state.update(buffers)
    ckpt = EVAL_DIR / "swin_l_seed1.pth"
    torch.save(state, ckpt)
    del model, state
    torch.cuda.empty_cache()
    forwards = sum(1 for _ in DetectionLoader(CocoDetection(str(img_dir), str(ann)), 4))
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
    t1 = time.perf_counter()
    stats = eval_entry.main(["--coco-img", str(img_dir), "--coco-ann", str(ann), "--model-config", str(cfg_path),
                             "--torch-checkpoint", str(ckpt), "--batch-size", "4"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(native.LAUNCHES)
    expect = {k: 0 for k in native.LAUNCHES}
    expect.update(msda=12 * forwards, grid_nms=forwards)
    if launches != expect:
        raise AssertionError(f"eval_swin_l: launch counts {launches} for {forwards} forwards")
    check_stats(stats, "eval_swin_l")
    print(f"eval_swin_l: Swin-L exact mode through salience_detr_torch.test.main --torch-checkpoint "
          f"({len(buffers)} upstream attention buffers in the file, dropped by name; strict load), "
          f"{len(EVAL_SIZES)} images in {forwards} forwards: launches={launches}, "
          f"stats={ {k: round(v, 6) for k, v in stats.items()} }, wall_s={wall:.3f} (model build included); "
          f"phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return launches


def phase_nms_past_budget(smi):
    """C-18: K2 at the 5-scale levels of the 800x1344 canvas (rank map in
    shared memory) and of a 1344x1344 canvas (past it: the global-memory
    rank map), K=3600, B=4, random candidates with a raster clump in image
    1; K9 at N=1024 (the conflict rows in the walking block's shared
    memory), 1400, 2048 and 4096 (in the filling blocks' shared memory),
    B=4, spread and crowded boxes.  Each exactly against its plain version,
    with times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, levels in (("5-scale 800x1344", FIVE_SCALE_LEVELS), ("5-scale 1344x1344", FIVE_SCALE_SQUARE)):
        S = sum(h * w for h, w in levels)
        topk = torch.stack([torch.randperm(S, generator=gen, device=dev)[:NMS_K] for _ in range(4)])
        topk[1] = torch.arange(NMS_K, device=dev)
        topk = topk.to(torch.int32).contiguous()
        got = grid_nms_topk(topk, levels, NMS_OUT)
        want = grid_nms_topk_plain(topk, levels, NMS_OUT)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        ms = cuda_ms(lambda: grid_nms_topk(topk, levels, NMS_OUT), 20)
        where = "global" if grid_nms_rank_in_global(NMS_K, S) else "shared"
        print(f"nms_past_budget: grid_nms {label} B=4 K={NMS_K} S={S} 13K+2S+1={13 * NMS_K + 2 * S + 1} B "
              f"rank map in {where} memory, mismatches={mismatches} kernel_ms={ms:.4f}; card: {smi}")
        if mismatches:
            raise AssertionError(f"grid_nms kernel differs from plain in {mismatches} entries at {label}")
    rng = np.random.default_rng(8)
    for n in (1024, 1400, 2048, 4096):
        for extent in (400.0, 60.0):
            xy = rng.uniform(0, extent * n / 1024, size=(4, n, 2)).astype(np.float32)
            wh = rng.uniform(5, 60, size=(4, n, 2)).astype(np.float32)
            boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(dev)
            got = nms_keep_mask(boxes, 0.5)
            want = nms_keep_mask_plain(boxes, 0.5)
            torch.cuda.synchronize()
            mismatches = int((got != want).sum())
            ms = cuda_ms(lambda: nms_keep_mask(boxes, 0.5), 20)
            run, _ = keep_launcher(boxes, 0.5)
            launch_ms = queued_ms(lambda: run(native.load()), 50)
            rows, C = nms_keep_plan(n)
            print(f"nms_past_budget: nms_keep B=4 N={n} {'crowded' if extent < 100 else 'spread'} rows in "
                  f"{rows} memory, cluster {C}, kept {int(got.sum())}, mismatches={mismatches} "
                  f"wrapper_ms={ms:.4f} kernel_ms={launch_ms:.4f} (launch only); card: {smi}")
            if mismatches:
                raise AssertionError(f"nms_keep kernel differs from plain in {mismatches} entries at N={n}")



# the ddp phases: two ranks of the flagship on the one card over gloo (NCCL
# refuses two ranks on one device), each started with the launcher's
# variables; where they write (an ignored directory of the checkout)
DDP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ddp"
DDP_WORLD, DDP_F32_STEPS, DDP_BF16_STEPS, DDP_STEPS_PER_EPOCH = 2, 2, 2, 4
# ddp_train's bounds against one process (float32, the default numerics of
# utils.env.configure_numerics).  Each step's losses and grad_norm on the
# same weights: step 0 from the seed, each later step from the ranks' own
# weights, optimizer moments and generator after the step before (one
# process continues from them), because the default numerics do not repeat
# past an update (K3's scatter design adds d_value with float atomics, and
# AdamW's first steps move a near-zero gradient entry by about +-lr
# whichever sign it rounds to).  Step 0 at rtol DDP_STEP0_RTOL; later steps
# at DDP_STEP_RTOL: at random init scores and costs sit near ties, and a
# rank's half batch runs other conv and GEMM algorithms than the whole batch,
# so a top-k, NMS or matching decision may fall the other way on a later
# batch (PERF.md: up to 1.9e-2 on one loss term at step 1 on the same
# weights; the tiny CPU tests hold 2e-5).  --use-deterministic-algorithms
# makes a run repeat itself bitwise (phase train_repeat), but not equal to
# one process in the default numerics: the first module output whose rows
# part from the whole batch's is the salience predictor's last Linear (a
# GEMM whose row count is the batch's, 4.2e-7 of its magnitude), and the
# salience top-k after it selects other tokens, so the ranks are held
# against one process at these bounds.  With the flag that Linear runs one
# GEMM an image (``models.layers.PerImageLinear``, ROADMAP C-27), and the
# ranks' step 0 is within 1.410e-05 of one process (``repeat_check ranks``,
# 2 gloo ranks on the H100, PERF.md), so ddp_cards holds its deterministic
# runs' step 0 at DDP_DET_STEP0_RTOL; their later steps continue from the
# ranks' own weights and are printed.  The parameters
# after the last step against the one-process run: the norm of the
# difference over the norm of what the steps moved them, whole model, at
# DDP_PARAM_GAP (AdamW divides out a gradient's scale, so this reads the
# update's direction; grad_norm reads the scale; a one-process rerun's own
# gap is printed beside it); the neck's running statistics elementwise at
# atol DDP_STATS_ATOL + rtol DDP_STATS_RTOL.  ddp_nccl holds one NCCL rank
# against the run without the launcher bitwise, both with the flag.
DDP_STEP0_RTOL, DDP_STEP_RTOL, DDP_PARAM_GAP, DDP_STATS_RTOL, DDP_STATS_ATOL = 1e-4, 5e-2, 0.15, 1e-3, 1e-4
DDP_DET_STEP0_RTOL = 1e-4


def ddp_flagship(dtype):
    return dataclasses.replace(load_config(DEFAULT_CONFIG), dtype=dtype)


def ddp_state(model):
    """The parameters and the neck's BatchNorm statistics, on the host."""
    state = {n: p.detach().cpu() for n, p in model.named_parameters()}
    state.update({n: b.detach().cpu() for n, b in model.named_buffers()
                  if ".neck." in n and n.rsplit(".", 1)[-1] in ("running_mean", "running_var")})
    return state


def ddp_rank_main(out):
    """One rank of phase ddp_train (``chip_smoke.py --ddp-rank DIR``, with
    the launcher's variables): the flagship through ``Trainer`` with the
    mesh, DDP_F32_STEPS float32 steps on the rows of the synthetic global
    batches (GT_COUNTS), then a bf16 warm-up step and DDP_BF16_STEPS timed
    steps whose kernel launches this rank counts; writes rank<r>.json (and
    rank 0 the model, optimizer and generator after the first step and the
    float32 state after the last)."""
    from salience_detr_torch.parallel.mesh import init_distributed, mean_over_ranks, shutdown
    from salience_detr_torch.utils.env import configure_numerics

    configure_numerics(exact_float32=True)
    out = Path(out)
    mesh = init_distributed("cuda", "gloo")
    try:
        trainer = Trainer(ddp_flagship(torch.float32), mesh.device, seed=0, steps_per_epoch=DDP_STEPS_PER_EPOCH,
                          mesh=mesh)
        f32, counts = [], []
        for i, batch in enumerate(trainer.batches(DDP_F32_STEPS, seed=0)):
            counts.append(batch["targets"].counts)
            metrics = trainer.step(batch, trainer.generator)
            f32.append({k: float(v) for k, v in mean_over_ranks(metrics).items()})
            if i == 0 and mesh.rank == 0:  # one process continues from here in phase ddp_train
                torch.save({"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict(),
                            "generator": trainer.generator.get_state()}, out / "after_step0.pt")
        state = ddp_state(trainer.model)
        sums = [float(v.double().sum()) for v in state.values()]
        same = all(s == sums for s in mesh.all_gather_object(sums))
        if mesh.rank == 0:
            torch.save(state, out / "state.pt")
        del trainer, state
        torch.cuda.empty_cache()

        trainer = Trainer(ddp_flagship(torch.bfloat16), mesh.device, seed=0, steps_per_epoch=1 + DDP_BF16_STEPS,
                          mesh=mesh)
        batches = list(trainer.batches(1 + DDP_BF16_STEPS, seed=1))
        trainer.step(batches[0], trainer.generator)
        torch.cuda.synchronize()
        mesh.barrier()
        torch.cuda.reset_peak_memory_stats()
        for k in native.LAUNCHES:
            native.LAUNCHES[k] = 0
        times, launches, finite = [], [], True
        for batch in batches[1:]:
            before = dict(native.LAUNCHES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            metrics = trainer.step(batch, trainer.generator)
            end.record()
            torch.cuda.synchronize()
            times.append({"wall_ms": 1e3 * (time.perf_counter() - t0), "device_ms": start.elapsed_time(end)})
            launches.append({k: native.LAUNCHES[k] - before[k] for k in native.LAUNCHES})
            finite &= all(bool(torch.isfinite(v)) for v in metrics.values())
        (out / f"rank{mesh.rank}.json").write_text(json.dumps({
            "f32": f32, "counts": counts, "ranks_equal": same, "bf16_times": times, "bf16_launches": launches,
            "bf16_finite": finite, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device": str(mesh.device), "world": mesh.world,
        }))
    finally:
        shutdown(mesh)


def phase_ddp_train(smi):
    """The flagship data-parallel over DDP_WORLD gloo ranks on this card,
    each its own process started with the launcher's variables
    (``--ddp-rank``): B=4 global on the 800x1344 canvas with GT_COUNTS, rank
    0 holding images (24, 7) and rank 1 (40, 1), so the ranks' largest gt
    counts, normalisers and salience positives differ from the global ones.
    DDP_F32_STEPS float32 steps held against the one-process ``Trainer``
    on the same batches and seed, made twice (every loss and grad_norm, the
    parameters and the neck's running statistics after the last step, at
    the bounds above; both ranks' states equal); then
    DDP_BF16_STEPS bf16 steps timed on each rank, whose launches must be 12
    K1, 12 K3, 1 K2 and 1 K4 a step on each rank.  The two ranks share one
    card: the time shows the data-parallel step's overhead and correctness,
    not scaling."""
    import shutil

    t0 = time.perf_counter()
    if DDP_DIR.exists():
        shutil.rmtree(DDP_DIR)
    out = DDP_DIR / "train"
    out.mkdir(parents=True)
    runs = []
    for _ in range(2):  # the one-process run and a rerun: the card's own run-to-run gap
        trainer = Trainer(ddp_flagship(torch.float32), "cuda", seed=0, steps_per_epoch=DDP_STEPS_PER_EPOCH)
        init = ddp_state(trainer.model)
        metrics = [{k: float(v) for k, v in trainer.step(batch, trainer.generator).items()}
                   for batch in trainer.batches(DDP_F32_STEPS, seed=0)]
        runs.append((metrics, ddp_state(trainer.model)))
        del trainer
        torch.cuda.empty_cache()
    (want, want_state), (again, again_state) = runs
    t1 = time.perf_counter()
    ddp_check.launch([str(Path(__file__).resolve()), "--ddp-rank", str(out)], DDP_WORLD, one_device=True,
                     timeout=900, cwd=str(Path(__file__).resolve().parent))
    ranks_s = time.perf_counter() - t1
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(DDP_WORLD)]
    got_state = torch.load(out / "state.pt", weights_only=True)
    if [r["counts"][0] for r in ranks] != [list(GT_COUNTS[:2]), list(GT_COUNTS[2:])]:
        raise AssertionError(f"ddp_train: ranks' gt counts {[r['counts'] for r in ranks]}")
    if not all(r["ranks_equal"] for r in ranks):
        raise AssertionError("ddp_train: the ranks' parameters differ after the float32 steps")

    def gaps(got):
        return [{k: abs(g[k] - v) / max(abs(v), 1e-12) for k, v in w.items()} for w, g in zip(want, got)]

    def param_gap(state):
        return param_gap_to(state, want_state)

    def param_gap_to(state, ref):
        diff = sum(float((state[n] - w).double().norm()) ** 2 for n, w in ref.items() if n not in stats)
        moved = sum(float((w - init[n]).double().norm()) ** 2 for n, w in ref.items() if n not in stats)
        return math.sqrt(diff / moved)

    def stats_gap(state):
        return max(float(((state[n] - want_state[n]).abs() / (DDP_STATS_ATOL + DDP_STATS_RTOL *
                                                               want_state[n].abs())).max()) for n in stats)

    # one process from the ranks' weights, moments and generator after step 0
    after0 = torch.load(out / "after_step0.pt", weights_only=True)
    trainer = Trainer(ddp_flagship(torch.float32), "cuda", seed=0, steps_per_epoch=DDP_STEPS_PER_EPOCH)
    trainer.model.load_state_dict(after0["model"], strict=True)
    trainer.optimizer.load_state_dict(after0["optimizer"])
    trainer.step.steps_done = 1
    trainer.generator.set_state(after0["generator"])
    same = [want[0]] + [{k: float(v) for k, v in trainer.step(batch, trainer.generator).items()}
                        for batch in list(trainer.batches(DDP_F32_STEPS, seed=0))[1:]]
    same_state = ddp_state(trainer.model)
    del trainer, after0
    torch.cuda.empty_cache()

    stats = [n for n in want_state if n.endswith(("running_mean", "running_var"))]
    ddp_gaps = [{k: abs(g[k] - v) / max(abs(v), 1e-12) for k, v in w.items()} for w, g in zip(same, ranks[0]["f32"])]
    rerun_gaps = gaps(again)
    facts = {f"step{i}": (max(d.values()), max(r.values())) for i, (d, r) in enumerate(zip(ddp_gaps, rerun_gaps))}
    facts["params"] = (param_gap(got_state), param_gap(again_state))
    facts["neck_stats"] = (stats_gap(got_state), stats_gap(again_state))
    worst = {f"step{i}": max(d, key=d.get) for i, d in enumerate(ddp_gaps)}
    bounds = {"step0": DDP_STEP0_RTOL, **{f"step{i}": DDP_STEP_RTOL for i in range(1, DDP_F32_STEPS)},
              "params": DDP_PARAM_GAP, "neck_stats": 1.0}
    print("ddp_train_gaps: " + ", ".join(f"{k} ddp {d:.3e} rerun {r:.3e} bound {bounds[k]:.3e}"
                                         for k, (d, r) in facts.items()) +
          f"; largest metric gaps {worst}; the last step's parameters against one process continuing from the "
          f"ranks' step 0: {param_gap_to(got_state, same_state):.3e} of what the steps moved them")
    if not all(math.isfinite(v) for m in ranks[0]["f32"] for v in m.values()):
        raise AssertionError(f"ddp_train: non-finite metrics {ranks[0]['f32']}")
    beyond = [k for k, (d, _) in facts.items() if d > bounds[k]]
    if beyond:
        raise AssertionError(f"ddp_train: {beyond} beyond their bounds against one process")
    per_step = {k: 0 for k in native.LAUNCHES}
    per_step.update(TRAIN_STEP_KERNELS)
    for r, rank in enumerate(ranks):
        for launches in rank["bf16_launches"]:
            if launches != per_step:
                raise AssertionError(f"ddp_train: rank {r} launched {launches} in a bf16 step")
        if not rank["bf16_finite"]:
            raise AssertionError(f"ddp_train: rank {r} bf16 metrics not finite")
    step_ms = [[round(t["device_ms"], 3) for t in rank["bf16_times"]] for rank in ranks]
    wall_ms = [[round(t["wall_ms"], 3) for t in rank["bf16_times"]] for rank in ranks]
    print(f"ddp_train: flagship R50 as {DDP_WORLD} gloo ranks on one card ({ranks[0]['device']}), B=4 global "
          f"(2 a rank) canvas 800x1344 gts {GT_COUNTS} (rank 0 {ranks[0]['counts'][0]}, rank 1 "
          f"{ranks[1]['counts'][0]}); {DDP_F32_STEPS} float32 steps against the one-process Trainer (and its "
          f"rerun): losses {[round(m['loss'], 4) for m in ranks[0]['f32']]} against "
          f"{[round(m['loss'], 4) for m in want]} (rerun {[round(m['loss'], 4) for m in again]}), grad_norm "
          f"{[round(m['grad_norm'], 4) for m in ranks[0]['f32']]} against {[round(m['grad_norm'], 4) for m in want]}; "
          f"gaps (ddp, rerun, bound) on the ddp_train_gaps line; ranks' states equal; {DDP_BF16_STEPS} bf16 steps "
          f"a rank: launches a step "
          f"{ {k: v for k, v in ranks[0]['bf16_launches'][0].items() if v} } on each rank, device step_ms by rank "
          f"{step_ms}, wall_ms by rank {wall_ms} (two ranks share one card: overhead and correctness, not "
          f"scaling), peak_mem_gib by rank {[round(r['peak_gib'], 3) for r in ranks]}; ranks' command "
          f"{ranks_s:.1f} s; phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return ranks


def run_cli(args, env=None, timeout=900):
    """``python args`` from the checkout's root, with no launcher variables
    unless ``env`` gives them; raises with its last output when it fails."""
    root = Path(__file__).resolve().parent
    run_env = {k: v for k, v in os.environ.items() if k not in ddp_mesh.LAUNCHER_VARS}
    run_env.update(env or {})
    run_env["PYTHONPATH"] = os.pathsep.join(p for p in (str(root), run_env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, *args], cwd=str(root), env=run_env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[:4])} exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return proc


def phase_ddp_nccl(smi):
    """A world of one rank over NCCL through the launcher (python -m
    torch.distributed.run --standalone --nproc_per_node 1 -m
    salience_detr_torch.train) on the train_coco phase's split, float32,
    --dry-run-steps 2 and the epoch's eval: NCCL init, DDP's all-reduce, the
    per-step counts all-reduce and the eval merge on the card; against the
    same command without the launcher and the same seed, both with
    --use-deterministic-algorithms: each step's losses and grad_norm
    (summary.json), the eval's stats and the checkpoint's weights must be
    bitwise equal."""
    t0 = time.perf_counter()
    root = DDP_DIR / "nccl"
    img_dir, ann = write_train_split(root / "split")
    runs = {}
    for name, launcher in (("nccl", ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"]),
                           ("single", [])):
        config = train_coco_config(root / f"{name}.py", img_dir, ann, root / name)
        t1 = time.perf_counter()
        proc = run_cli([*launcher, "-m", "salience_detr_torch.train", "--config-file", config, "--seed", "0",
                        "--dry-run-steps", "2", "--mixed-precision", "no", "--use-deterministic-algorithms"])
        summary = json.loads((root / name / "summary.json").read_text())
        runs[name] = (summary, time.perf_counter() - t1, proc.stdout)
    (nccl, nccl_s, log), (single, single_s, _) = runs["nccl"], runs["single"]
    if "data parallel: 1 ranks" not in log or not nccl["global_step"] == single["global_step"] == 2:
        raise AssertionError(f"ddp_nccl: log or steps {nccl['global_step']}, {single['global_step']}")

    def gap(a, b):
        return max(abs(a[k] - v) / max(abs(v), 1e-12) for k, v in b.items() if k != "step")

    first_gap = gap(nccl["logged"][0], single["logged"][0])
    last_gap = gap(nccl["metrics"], single["metrics"])
    stats_gap = max(abs(nccl["stats"][k] - v) for k, v in single["stats"].items())
    a = CheckpointManager(str(root / "nccl" / "checkpoints")).restore()["model"]
    b = CheckpointManager(str(root / "single" / "checkpoints")).restore()["model"]
    bitwise = all(torch.equal(a[k], b[k]) for k in b)
    weight_gap = max(float((a[k].float() - b[k].float()).abs().max()) for k in b)
    if first_gap or last_gap or stats_gap or not bitwise or nccl["logged"] != single["logged"]:
        raise AssertionError(f"ddp_nccl: not bitwise equal to one process: first step {first_gap:.3e}, last step "
                             f"{last_gap:.3e}, stats {stats_gap:.3e}, weights {weight_gap:.3e}")
    print(f"ddp_nccl: salience_detr_torch.train under torch.distributed.run (1 rank, NCCL on cuda:0, gloo side "
          f"group) on {len(TRAIN_COCO_SIZES)} .npy images, float32, 2 steps + eval: losses "
          f"{[round(m['loss'], 6) for m in nccl['logged']]} grad_norm {[round(m['grad_norm'], 6) for m in nccl['logged']]} "
          f"AP {nccl['stats']['AP']:.6f} against one process without the launcher losses "
          f"{[round(m['loss'], 6) for m in single['logged']]} grad_norm "
          f"{[round(m['grad_norm'], 6) for m in single['logged']]} AP {single['stats']['AP']:.6f}, both with "
          f"--use-deterministic-algorithms: largest relative metric gap step 0 {first_gap:.3e}, step 1 "
          f"{last_gap:.3e}, stats gap {stats_gap:.3e}, checkpoint weights bitwise equal {bitwise} (all must be "
          f"bitwise); host transform ms a sample (the detr preset, 8 worker threads) "
          f"{1e3 * nccl['transform_s'] / max(nccl['samples'], 1):.3f}; command wall_s launcher "
          f"{nccl_s:.1f} single {single_s:.1f}; phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return nccl, single


def prediction_gap(a_path, b_path):
    """(images whose predictions differ, largest |score| and |box| difference
    between two COCO result files, each image's predictions in score order)."""
    def by_image(path):
        out = {}
        for r in json.loads(path.read_text()):
            out.setdefault(r["image_id"], []).append(r)
        return {k: sorted(v, key=lambda r: -r["score"]) for k, v in out.items()}

    a, b = by_image(a_path), by_image(b_path)
    differ, score_gap, box_gap = 0, 0.0, 0.0
    for img in set(a) | set(b):
        x, y = a.get(img, []), b.get(img, [])
        differ += x != y
        for p, q in zip(x, y):
            score_gap = max(score_gap, abs(p["score"] - q["score"]))
            box_gap = max(box_gap, max(abs(u - v) for u, v in zip(p["bbox"], q["bbox"])))
    return differ, score_gap, box_gap


def rescored(ann, path):
    """The 12 stats of a COCO result file, scored in this process."""
    ev = CocoEvaluator(CocoIndex(str(ann)))
    by_img = {}
    for r in json.loads(path.read_text()):
        x, y, w, h = r["bbox"]
        d = by_img.setdefault(r["image_id"], {"boxes": [], "scores": [], "labels": []})
        d["boxes"].append([x, y, x + w, y + h])
        d["scores"].append(r["score"])
        d["labels"].append(r["category_id"])
    ev.update({k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in by_img.items()})
    ev.accumulate()
    return ev.summarize()


def predictions_as_ground_truth(ann, path, out, per_image=3):
    """A copy of the annotation file ``ann`` whose boxes are the top
    ``per_image`` predictions of each image in the result file ``path``: a
    split on which the random-weight model scores above zero."""
    data = json.loads(Path(ann).read_text())
    preds = {}
    for r in json.loads(path.read_text()):
        preds.setdefault(r["image_id"], []).append(r)
    data["annotations"] = [
        {"id": i + 1, "image_id": r["image_id"], "category_id": r["category_id"], "bbox": r["bbox"],
         "area": r["bbox"][2] * r["bbox"][3], "iscrowd": 0}
        for i, r in enumerate(r for v in preds.values() for r in sorted(v, key=lambda r: -r["score"])[:per_image])]
    out.write_text(json.dumps(data))
    return out


def phase_ddp_eval(smi):
    """Two gloo ranks of salience_detr_torch.test on this card (the
    launcher's variables, LOCAL_RANK 0 for both) in exact mode
    (--torch-checkpoint, a saved seed-1 exact-mode state dict) on the eval
    phase's split at --batch-size 2, against the same command in one process,
    made three times (``repeat_check eval``, which records each module
    output of the first batch): the three one-process result files and the
    merged one must be byte-equal (ROADMAP C-26: cuDNN's attention gave the
    first process of a call other bits), and so must the merged file's
    stats (rescored here on the split and on one whose boxes are the top
    predictions, where the random-weight model scores above zero); rank 0
    logs the stats and rank 1 nothing, and one result file is written, by
    rank 0."""
    t0 = time.perf_counter()
    root = DDP_DIR / "eval"
    img_dir, ann = write_eval_split(root / "split")
    model, _ = build_salience_detr(exact_sampling(load_config(DEFAULT_CONFIG)), torch.device("cuda"),
                                   torch.Generator().manual_seed(1))
    ckpt = root / "exact_seed1.pth"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    del model
    torch.cuda.empty_cache()
    args = ["-m", "salience_detr_torch.test", "--coco-img", str(img_dir), "--coco-ann", str(ann),
            "--torch-checkpoint", str(ckpt), "--batch-size", "2"]
    singles = ("one", "again", "third")
    for d in (*singles, "ranks"):
        (root / d).mkdir()
    one_s = []
    for d in singles:  # each records its first batch's module outputs
        t1 = time.perf_counter()
        run_cli(["-m", "salience_detr_torch.tools.repeat_check", "eval", "--out", str(root / d / "record.json"),
                 "--", *args[2:], "--save-results", str(root / d / "predictions.json")])
        one_s.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    done = ddp_check.launch(args + ["--dist-backend", "gloo", "--save-results",
                                    str(root / "ranks" / "predictions.json")], DDP_WORLD, one_device=True,
                            timeout=900, cwd=str(Path(__file__).resolve().parent))
    ranks_s = time.perf_counter() - t1
    files = sorted(p.name for p in (root / "ranks").iterdir())
    if files != ["predictions.json"]:
        raise AssertionError(f"ddp_eval: result files {files}")
    runs = {d: root / d / "predictions.json" for d in singles}
    ranks = root / "ranks" / "predictions.json"
    gaps = {d: prediction_gap(path, ranks) for d, path in runs.items()}
    records = subprocess.run([sys.executable, "-m", "salience_detr_torch.tools.repeat_check", "compare",
                              *(str(root / d / "record.json") for d in singles)],
                             cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True)
    logged = [x for x in done[0].stdout.splitlines() if " AP=" in x]
    print(f"ddp_eval_facts: the merged predictions against each one-process run (images that differ, largest "
          f"score and box gaps) {gaps}; the one-process runs' first batches and result files: "
          f"{records.stdout.strip()}")
    same = all(ranks.read_bytes() == path.read_bytes() for path in runs.values())
    if not same or records.returncode != 0 or any(g[0] for g in gaps.values()) or not logged \
            or done[1].stdout.strip():
        raise AssertionError(f"ddp_eval: the merged and the one-process result files byte-equal {same}; "
                             f"merged predictions against "
                             f"them {gaps}; rank 0 logged {logged[-1:]}; rank 1 printed {done[1].stdout[-500:]}")
    equal = list(singles)
    ref = runs[equal[0]]
    scored = predictions_as_ground_truth(ann, ref, root / "top3_as_gt.json")
    stats = {split: (rescored(a, ranks), rescored(a, ref)) for split, a in (("split", ann), ("top3", scored))}
    if any(got != want for got, want in stats.values()) or not stats["top3"][0]["AP"] > 0:
        raise AssertionError(f"ddp_eval: stats {stats}")
    forwards = len(DetectionLoader(CocoDetection(str(img_dir), str(ann)), 2).plan())
    print(f"ddp_eval: salience_detr_torch.test --torch-checkpoint (exact mode) as {DDP_WORLD} gloo ranks on one "
          f"card, {len(EVAL_SIZES)} images in {forwards} batches of <=2 (rank r the batches r, r + 2, ...): the "
          f"merged result file equals one-process run {equal} bitwise, its stats equal exactly (split AP "
          f"{stats['split'][0]['AP']:.6f}; on its top-3 predictions as ground truth AP {stats['top3'][0]['AP']:.6f} "
          f"AR100 {stats['top3'][0]['AR100']:.6f}); one result file; wall_s one process "
          f"{[round(x, 1) for x in one_s]}, ranks "
          f"{ranks_s:.1f} (process start and model build included); phase_s={time.perf_counter() - t0:.2f}; "
          f"card: {smi}")


# phase ddp_cards: W = min(4, cards) NCCL ranks, one a card (LOCAL_RANK = r)
CARDS_DIR = DDP_DIR.parent / "chip_smoke_cards"
CARDS_F32_STEPS, CARDS_BF16_STEPS = 2, 2
SCALE_IMAGES, SCALE_WARMUP, SCALE_TIMED = 4, 2, 6  # images a card, warm-up and timed bf16 steps


def state_digest(model) -> str:
    """SHA-1 of the parameters and the neck's BatchNorm statistics
    (``ddp_state``), in order."""
    import hashlib

    h = hashlib.sha1()
    for name, t in ddp_state(model).items():
        h.update(name.encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def nccl_overlap(prof):
    """From a device trace: the NCCL kernels' ms and the ms of them during
    which another kernel ran (the backward's, on the compute stream)."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end, "nccl" in e.name.lower())
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    merged = []
    for start, end, _ in sorted(s for s in spans if not s[2]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    nccl_us = overlap_us = 0.0
    for start, end, is_nccl in spans:
        if not is_nccl:
            continue
        nccl_us += end - start
        overlap_us += sum(max(0, min(end, b) - max(start, a)) for a, b in merged)
    return nccl_us / 1e3, overlap_us / 1e3


def cards_rank_main(out):
    """One rank of phase ddp_cards (``chip_smoke.py --cards-rank DIR``, with
    the launcher's variables; DIR/spec.json names the mode).  ``train``:
    the flagship ``Trainer`` with the process group, CARDS_F32_STEPS
    float32 then CARDS_BF16_STEPS bf16 steps on the rows of the synthetic
    global batches (GT_COUNTS), each step's metrics averaged over the ranks,
    each rank's state digest after each step, the bf16 steps' launches;
    rank 0 writes the float32 state.  ``scale``: bf16 steps of
    SCALE_IMAGES images a rank, timed after a warm-up, then two steps
    traced on rank 0 for the NCCL kernels and their overlap."""
    from salience_detr_torch.parallel.mesh import init_distributed, mean_over_ranks, shutdown
    from salience_detr_torch.utils.env import configure_numerics

    out = Path(out)
    spec = json.loads((out / "spec.json").read_text())
    configure_numerics(spec["deterministic"], exact_float32=True)
    mesh = init_distributed("cuda", spec["backend"])
    try:
        record = {"device": str(mesh.device), "world": mesh.world, "design": backward_design()}
        if spec["mode"] == "train":
            for dtype, steps, key in ((torch.float32, CARDS_F32_STEPS, "f32"), (torch.bfloat16, CARDS_BF16_STEPS,
                                                                                   "bf16")):
                trainer = Trainer(ddp_flagship(dtype), mesh.device, seed=0, steps_per_epoch=DDP_STEPS_PER_EPOCH,
                                  mesh=mesh)
                metrics, digests, launches = [], [], []
                for batch in trainer.batches(steps, seed=0):
                    before = dict(native.LAUNCHES)
                    m = trainer.step(batch, trainer.generator)
                    torch.cuda.synchronize()
                    launches.append({k: native.LAUNCHES[k] - before[k] for k in native.LAUNCHES})
                    metrics.append({k: float(v) for k, v in mean_over_ranks(m).items()})
                    digests.append(state_digest(trainer.model))
                record[key] = {"metrics": metrics, "digests": digests, "launches": launches,
                               "ranks_equal": [len(set(d)) == 1 for d in zip(*mesh.all_gather_object(digests))]}
                if dtype == torch.float32 and mesh.rank == 0:
                    torch.save(ddp_state(trainer.model), out / "state.pt")
                del trainer
                torch.cuda.empty_cache()
        else:
            from torch.profiler import ProfilerActivity, profile

            trainer = Trainer(ddp_flagship(torch.bfloat16), mesh.device, seed=0,
                              steps_per_epoch=SCALE_WARMUP + SCALE_TIMED + 2, mesh=mesh)
            counts = GT_COUNTS * (SCALE_IMAGES * mesh.world // len(GT_COUNTS))
            batches = list(trainer.batches(SCALE_WARMUP + SCALE_TIMED + 2, seed=2, counts=counts))
            for batch in batches[:SCALE_WARMUP]:
                trainer.step(batch, trainer.generator)
            torch.cuda.synchronize()
            mesh.barrier()
            wall, device = [], []
            for batch in batches[SCALE_WARMUP:SCALE_WARMUP + SCALE_TIMED]:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                trainer.step(batch, trainer.generator)
                end.record()
                torch.cuda.synchronize()
                wall.append(1e3 * (time.perf_counter() - t0))
                device.append(start.elapsed_time(end))
            mesh.barrier()
            nccl = (0.0, 0.0)
            if mesh.rank == 0:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for batch in batches[-2:]:
                        trainer.step(batch, trainer.generator)
                    torch.cuda.synchronize()
                nccl = tuple(x / 2 for x in nccl_overlap(prof))
            else:
                for batch in batches[-2:]:
                    trainer.step(batch, trainer.generator)
                torch.cuda.synchronize()
            record.update(wall_ms=wall, device_ms=device, nccl_ms=nccl[0], nccl_overlap_ms=nccl[1],
                          grad_bytes=4 * sum(p.numel() for p in trainer.model.parameters() if p.requires_grad),
                          images=len(batches[0]["images"]))
        (out / f"rank{mesh.rank}.json").write_text(json.dumps(record))
    finally:
        shutdown(mesh)


def launch_cards(out, spec, world, one_device):
    """``cards_rank_main`` as ``world`` ranks, one a card (or sharing card 0)."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    ddp_check.launch([str(Path(__file__).resolve()), "--cards-rank", str(out)], world, one_device=one_device,
                     timeout=900, cwd=str(Path(__file__).resolve().parent))
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)], time.perf_counter() - t0


def loader_share(split, preset, copypaste, world, root):
    """One epoch of the written split through ``TrainLoader`` in ``world``
    gloo ranks on the host sharing the preparation
    (``ddp_check loader``): each rank's samples prepared and host
    transform ms a sample."""
    img_dir, ann = split
    root.mkdir(parents=True, exist_ok=True)
    spec = root / "spec.json"
    spec.write_text(json.dumps({
        "img_dir": str(img_dir), "ann": str(ann), "preset": preset, "copypaste": copypaste, "batch": 4,
        "canvas": [800, 1344], "max_gt": 100, "seed": 0, "num_workers": 8, "accumulate": 1, "stop_after": 1,
    }))
    ddp_check.launch(["-m", "salience_detr_torch.tools.ddp_check", "loader", "--spec", str(spec), "--out", str(root)],
                     world, timeout=900, cwd=str(Path(__file__).resolve().parent))
    ranks = [np.load(root / f"rank{r}.npz") for r in range(world)]
    return ([int(r["e1_samples"]) for r in ranks],
            [round(1e3 * float(r["e1_transform_s"]) / max(int(r["e1_samples"]), 1), 3) for r in ranks])


def phase_ddp_cards(smi, one_card=False):
    """Data-parallel over W = min(4, cards) NCCL ranks, one a card
    (``torch.cuda.device_count() >= 2``; on one card it prints why it did
    not run; ``one_card``, the rehearsal, runs it as 2 gloo ranks sharing
    card 0, whose times are not scaling):

    * train: the flagship ``Trainer`` (``cards_rank_main`` train) on the
      global batch GT_COUNTS against one process, both with the default
      numerics: step 0 within DDP_STEP0_RTOL, the later step and the
      parameters at ddp_train's bounds; every rank's state digest equal to
      rank 0's after every step;
    * rerun: the same W-rank run twice with --use-deterministic-algorithms'
      numerics, bitwise equal (metrics and digests), each bf16 step
      launching 12 K1, 12 K3 (the ordered design), 1 K2 and 1 K4, against
      one process with those numerics (a rank of a world of one): step 0
      within DDP_DET_STEP0_RTOL (the salience predictor's last Linear runs
      one GEMM an image under them: ROADMAP C-27), later steps printed;
    * train CLI: ``torch.distributed.run --nproc_per_node W -m
      salience_detr_torch.train --use-deterministic-algorithms`` on the
      train_coco split, 2 steps and the eval, twice: summaries and
      checkpoints bitwise equal;
    * eval CLI: ``salience_detr_torch.test`` (exact mode) as W ranks: the
      merged result file byte-equal to one process's;
    * scaling: bf16 steps of SCALE_IMAGES images a card at W = 1, 2, 4 (up
      to the cards there are): a rank's step ms (median of SCALE_TIMED),
      img/s, efficiency against W = 1, the NCCL kernels' device ms a step
      and their overlap with other kernels (rank 0's trace), the float32
      gradient bytes a step;
    * loader: one epoch of the train_coco split through the shared
      ``TrainLoader`` at W ranks on the host, detr and strong_album with
      copy-paste: samples prepared a rank and host ms a sample."""
    cards = torch.cuda.device_count()
    if cards < 2 and not one_card:
        print(f"ddp_cards: not run: {cards} CUDA card(s) here, the phase needs 2 or more "
              f"(on a host with four cards: python3 chip_smoke.py --phases ddp_cards)")
        return None
    t0 = time.perf_counter()
    import shutil

    if CARDS_DIR.exists():
        shutil.rmtree(CARDS_DIR)
    world, backend = (2, "gloo") if one_card else (min(4, cards), "nccl")
    dist_args = ["--dist-backend", backend]

    # train: one process and the ranks with the default numerics, then the
    # ranks twice with --use-deterministic-algorithms' numerics, against one
    # process with them (a rank of a world of one, in a process of its own:
    # cuBLAS reads its workspace setting when it starts)
    trainer = Trainer(ddp_flagship(torch.float32), "cuda", seed=0, steps_per_epoch=DDP_STEPS_PER_EPOCH)
    init = ddp_state(trainer.model)
    want = [{k: float(v) for k, v in trainer.step(batch, trainer.generator).items()}
            for batch in trainer.batches(CARDS_F32_STEPS, seed=0)]
    want_state = ddp_state(trainer.model)
    del trainer
    torch.cuda.empty_cache()
    runs = [launch_cards(CARDS_DIR / f"train{i}", {"mode": "train", "backend": backend, "deterministic": i > 0},
                         world, one_card) for i in range(3)]
    (first, first_s), (det, _), (det_again, _) = runs
    (one_det,), _ = launch_cards(CARDS_DIR / "one_det", {"mode": "train", "backend": "gloo", "deterministic": True},
                                 1, True)
    got_state = torch.load(CARDS_DIR / "train0" / "state.pt", weights_only=True)
    same_runs = [{k: r[k] for k in ("f32", "bf16")} for r in det] == [{k: r[k] for k in ("f32", "bf16")}
                                                                       for r in det_again]
    ranks_equal = all(all(r[k]["ranks_equal"]) for run in (first, det) for r in run for k in ("f32", "bf16"))
    step_gaps = [max(abs(g[k] - v) / max(abs(v), 1e-12) for k, v in w.items())
                 for w, g in zip(want, first[0]["f32"]["metrics"])]
    det_gaps = [max(abs(g[k] - v) / max(abs(v), 1e-12) for k, v in w.items())
                for w, g in zip(one_det["f32"]["metrics"], det[0]["f32"]["metrics"])]
    stats = [n for n in want_state if n.endswith(("running_mean", "running_var"))]
    diff = sum(float((got_state[n] - w).double().norm()) ** 2 for n, w in want_state.items() if n not in stats)
    moved = sum(float((w - init[n]).double().norm()) ** 2 for n, w in want_state.items() if n not in stats)
    param_gap = math.sqrt(diff / moved)
    per_step = {k: 0 for k in native.LAUNCHES}
    per_step.update({"msda": 12, "msda_backward_ordered": 12, "grid_nms": 1, "hungarian": 1})
    launches_ok = all(l == per_step for r in det for l in r["bf16"]["launches"])
    finite = all(math.isfinite(v) for run in (first, det) for r in run for k in ("f32", "bf16")
                 for m in r[k]["metrics"] for v in m.values())
    print(f"ddp_cards_train: flagship R50 as {world} {backend} ranks ({[r['device'] for r in first]}), B=4 global "
          f"({4 // world} a rank) gts {GT_COUNTS}; float32 losses {[m['loss'] for m in first[0]['f32']['metrics']]!r} "
          f"against one process {[m['loss'] for m in want]!r}: largest relative metric gap by step "
          f"{[f'{g:.3e}' for g in step_gaps]} (bounds {DDP_STEP0_RTOL}, {DDP_STEP_RTOL}); parameters after "
          f"{CARDS_F32_STEPS} steps {param_gap:.3e} of what they moved (bound {DDP_PARAM_GAP}); with "
          f"--use-deterministic-algorithms (K3 design {det[0]['design']}) by step {[f'{g:.3e}' for g in det_gaps]} "
          f"(step 0 bound {DDP_DET_STEP0_RTOL}) from one process with them, and the rerun bitwise equal "
          f"{same_runs}; ranks' state digests equal after "
          f"every step {ranks_equal}; bf16 launches a step on each rank (deterministic) "
          f"{ {k: v for k, v in det[0]['bf16']['launches'][0].items() if v} }; ranks' command {first_s:.1f} s")
    if (step_gaps[0] > DDP_STEP0_RTOL or any(g > DDP_STEP_RTOL for g in step_gaps[1:]) or param_gap > DDP_PARAM_GAP
            or det_gaps[0] > DDP_DET_STEP0_RTOL or not ranks_equal or not same_runs or not launches_ok or not finite):
        raise AssertionError("ddp_cards: the W-rank train run is beyond its bounds, differs between ranks or "
                             "between its deterministic runs, or launched other kernels (ddp_cards_train line)")

    # the train CLI under the launcher, twice, deterministic
    img_dir, ann = write_train_split(CARDS_DIR / "split")
    n_train = len(CocoDetection(str(img_dir), str(ann), train=True))  # images with annotations
    cli = []
    for i in range(2):
        out_dir = CARDS_DIR / f"cli{i}"
        config = train_coco_config(CARDS_DIR / f"cli{i}.py", img_dir, ann, out_dir)
        t1 = time.perf_counter()
        train_args = ["-m", "salience_detr_torch.train", "--config-file", config, "--seed", "0", "--dry-run-steps",
                      "2", "--use-deterministic-algorithms", *dist_args]
        if one_card:  # the launcher would give rank 1 cuda:1
            ddp_check.launch(train_args, world, one_device=True, timeout=900,
                             cwd=str(Path(__file__).resolve().parent))
        else:
            run_cli(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(world), *train_args])
        summary = json.loads((out_dir / "summary.json").read_text())
        cli.append((summary, CheckpointManager(str(out_dir / "checkpoints")).restore(), time.perf_counter() - t1))
    keys = ("metrics", "logged", "stats", "global_step", "samples")
    same_summary = all(cli[0][0][k] == cli[1][0][k] for k in keys)
    a, b = cli[0][1], cli[1][1]
    same_ckpt = all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"]) and \
        str(a["optimizer"]) == str(b["optimizer"])
    if not same_summary or not same_ckpt or cli[0][0]["global_step"] != 2:
        raise AssertionError(f"ddp_cards: two deterministic train CLI runs differ (summaries equal "
                             f"{same_summary}, checkpoints equal {same_ckpt})")

    # the eval CLI as W ranks against one process
    eval_img, eval_ann = write_eval_split(CARDS_DIR / "eval_split")
    model, _ = build_salience_detr(exact_sampling(load_config(DEFAULT_CONFIG)), torch.device("cuda"),
                                   torch.Generator().manual_seed(1))
    ckpt = CARDS_DIR / "exact_seed1.pth"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    del model
    torch.cuda.empty_cache()
    args = ["-m", "salience_detr_torch.test", "--coco-img", str(eval_img), "--coco-ann", str(eval_ann),
            "--torch-checkpoint", str(ckpt), "--batch-size", "2"]
    run_cli(args + ["--save-results", str(CARDS_DIR / "eval_one.json")])
    ddp_check.launch(args + [*dist_args, "--save-results", str(CARDS_DIR / "eval_ranks.json")], world,
                     one_device=one_card, timeout=900, cwd=str(Path(__file__).resolve().parent))
    eval_equal = (CARDS_DIR / "eval_one.json").read_bytes() == (CARDS_DIR / "eval_ranks.json").read_bytes()
    if not eval_equal:
        raise AssertionError(f"ddp_cards: the {world}-rank eval's merged result file differs from one process's: "
                             f"{prediction_gap(CARDS_DIR / 'eval_one.json', CARDS_DIR / 'eval_ranks.json')}")
    print(f"ddp_cards_cli: the train CLI under torch.distributed.run --nproc_per_node {world} "
          f"--use-deterministic-algorithms, 2 steps + eval, twice: summaries equal {same_summary} (losses "
          f"{[m['loss'] for m in cli[0][0]['logged']]!r}, AP {cli[0][0]['stats']['AP']!r}), checkpoints bitwise "
          f"equal {same_ckpt}, wall_s {[round(c[2], 1) for c in cli]}, samples prepared (rank 0) "
          f"{cli[0][0]['samples']} of {n_train}; the eval CLI (exact mode) as {world} ranks: the merged "
          f"result file byte-equal to one process's {eval_equal}")

    # scaling: 4 images a card at W = 1, 2, 4
    scale = {}
    for w in ([1, 2] if one_card else [x for x in (1, 2, 4) if x <= cards]):
        ranks, _ = launch_cards(CARDS_DIR / f"scale{w}", {"mode": "scale", "backend": backend,
                                                          "deterministic": False}, w, one_card)
        step_ms = max(statistics.median(r["wall_ms"]) for r in ranks)
        scale[w] = {"step_ms": round(step_ms, 3), "device_ms": round(statistics.median(ranks[0]["device_ms"]), 3),
                    "img_s": round(SCALE_IMAGES * w * 1e3 / step_ms, 3), "nccl_ms": round(ranks[0]["nccl_ms"], 3),
                    "nccl_overlap_ms": round(ranks[0]["nccl_overlap_ms"], 3)}
        grad_bytes = ranks[0]["grad_bytes"]
    for w, row in scale.items():
        row["efficiency"] = round(row["img_s"] / (w * scale[1]["img_s"]), 4)
    print(f"ddp_cards_scaling: flagship R50 bf16, {SCALE_IMAGES} images a card, {backend}; by W: {scale} (step_ms: "
          f"the slowest rank's median wall of {SCALE_TIMED} steps after {SCALE_WARMUP}; device_ms rank 0's events; "
          f"nccl_ms: rank 0's NCCL kernels a step, nccl_overlap_ms of them beside another kernel, from a "
          f"torch.profiler trace of 2 steps); float32 gradient bytes a step {grad_bytes}"
          f"{' (one card shared: not scaling)' if one_card else ''}")

    # the loader's shared preparation over the host, one epoch of the split
    parts = []
    for preset, copypaste in (("detr", False), ("strong_album", True)):
        samples, ms = loader_share((img_dir, ann), preset, copypaste, world, CARDS_DIR / f"loader_{preset}")
        parts.append(f"{preset}{' + copy-paste' if copypaste else ''}: samples prepared by rank {samples} of "
                     f"{n_train} (every rank prepared all {n_train} before), host ms a sample by rank {ms}")
    print(f"ddp_cards_loader: one epoch of the {n_train}-image split through TrainLoader at {world} "
          f"ranks, global batch 4, 8 worker threads a rank: {'; '.join(parts)}")
    print(f"ddp_cards: {world} {backend} ranks: train, rerun, train CLI, eval CLI, scaling and loader held; "
          f"phase_s={time.perf_counter() - t0:.2f}; card: {smi}")
    return scale


def kernel_entry(name, source, replaces, launches, err, timing):
    ms, plain_ms, bound_ms, bound_by, *library = timing
    return {"name": name, "route": "cuda", "source": f"salience_detr_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library[0] if library else None}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-csrc", nargs="*", default=[], metavar="DIR",
                        help="directories holding another version of csrc/ (or some of its sources), "
                             "whose MSDA, grid-NMS, assignment, keep-mask, DCN, int8 MSDA and gather-sum "
                             "kernels are timed in turns with these on the captured inputs and the "
                             "phases' other inputs")
    parser.add_argument("--ddp-rank", default=None, metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--cards-rank", default=None, metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--ddp-cards-on-one-card", action="store_true",
                        help="rehearse phase ddp_cards on one card: 2 gloo ranks share it (no scaling figure)")
    parser.add_argument("--phases", nargs="+", default=None,
                        choices=("msda_ordered", "deform_conv", "dcn_captured", "steps_e2e", "train_repeat",
                                 "ddp_train", "ddp_nccl", "ddp_eval", "ddp_cards", "numerics_cost", "serve_q8",
                                 "tools"),
                        help="run the device and build phases and these alone, and print no result line")
    args = parser.parse_args(argv)
    if args.ddp_rank is not None:
        return ddp_rank_main(args.ddp_rank)
    if args.cards_rank is not None:
        return cards_rank_main(args.cards_rank)
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    configure_numerics(exact_float32=True)  # the card held against the CPU and against other processes
    if args.phases is not None:
        for name in args.phases:
            if name == "ddp_cards":
                phase_ddp_cards(smi, args.ddp_cards_on_one_card)
            elif name == "msda_ordered":
                phase_msda_ordered(smi, baselines=args.baseline_csrc)
            elif name in ("deform_conv", "dcn_captured"):
                globals()[f"phase_{name}"](smi, args.baseline_csrc)
            else:
                globals()[f"phase_{name}"](smi)
            torch.cuda.empty_cache()
        print(f"wall_s_total={time.perf_counter() - t_start:.1f}")
        return 0
    msda_err, msda_t = phase_msda()
    phase_grid_nms()
    phase_slice()
    serve_launches, _, _ = phase_serve(smi)
    bwd_err, bwd_t = phase_msda_backward()
    phase_msda_groups(smi)
    phase_hungarian()
    phase_train_slice()
    train_launches = phase_train(smi)
    captured = capture_train_inputs()
    phase_msda_captured(smi, args.baseline_csrc, captured)
    ordered_err, ordered_t = phase_msda_ordered(smi, captured, args.baseline_csrc)
    assignment = captured.pop("assignment")
    nms_t, hung_t = phase_nms_assignment_captured(smi, args.baseline_csrc, assignment)
    del captured
    mixed_launches = phase_mixed_assignment(smi, assignment)
    del assignment
    keep_t = phase_nms_keep(smi, args.baseline_csrc)
    eval_launches = phase_eval(smi)
    coco_launches, ordered_launches, detr_transform_ms = phase_train_coco(smi)
    strong_launches = phase_train_coco_strong(smi, detr_transform_ms)
    dcn_fwd_err, dcn_bwd_err, dcn_t, fused_err, fused_t = phase_deform_conv(smi, args.baseline_csrc)
    phase_dcn_captured(smi, args.baseline_csrc)
    phase_dcn_slice()
    dcn_serve_launches = phase_dcn_serve(smi)
    dcn_train_launches = phase_dcn_train(smi)
    q8_sample_err, q8_t = phase_msda_q8(smi, args.baseline_csrc)
    q8_launches = phase_serve_q8(smi)
    phase_tools(smi)
    stage_launches, stage_results = phase_msda_stages(smi, args.baseline_csrc)
    phase_nms_past_budget(smi)
    phase_backbone_slice()
    phase_msda_backbone_shapes(smi)
    backbone_launches = {}
    for name in ("swin_l", "convnext_l", "focalnet_l", "r50_5scale", "eva02_b"):
        backbone_launches[f"serve_{name}"] = phase_backbone_serve(smi, name)
    for name in ("swin_l", "convnext_l", "focalnet_l", "r50_5scale"):
        backbone_launches[f"train_{name}"] = phase_backbone_train(smi, name)
    backbone_launches["eval_swin_l"] = phase_eval_swin(smi)
    phase_train_repeat(smi)
    ddp_ranks = phase_ddp_train(smi)
    phase_ddp_nccl(smi)
    phase_ddp_eval(smi)
    phase_ddp_cards(smi)
    print("backbone launches " + "; ".join(
        f"{k} {{{', '.join(f'{n}: {v}' for n, v in l.items() if v)}}}" for k, l in backbone_launches.items()))
    print(f"serve launches {serve_launches}; train launches {train_launches}; "
          f"train_coco launches (run 1, 4 steps) {coco_launches}; "
          f"train_coco_strong launches ({STRONG_STEPS} steps) {strong_launches}; "
          f"train_mixed launches (1 step) {mixed_launches}; "
          f"eval launches (NMS filter on) {eval_launches}; dcn_serve launches {dcn_serve_launches}; "
          f"dcn_train launches {dcn_train_launches}; serve_q8 launches {q8_launches}; "
          f"msda_stages launches {stage_launches}")
    # K1-K4, K9: no single PyTorch call computes them (MSDA is a grid_sample
    # per level and a weighted sum; PyTorch has no NMS or assignment op).  K2,
    # K4 and K9 are exact, and timed on the main path's own inputs.  K1-K4
    # launches: the train CLI's 4 steps on COCO-format data (phase train_coco)
    kernels = [
        kernel_entry("msda_forward", "msda.cu", "salience_detr_tpu/ops/deform_attn.py:768",
                     coco_launches["msda"], msda_err, msda_t),
        kernel_entry("grid_nms_forward", "grid_nms.cu", "salience_detr_tpu/ops/nms.py:68",
                     coco_launches["grid_nms"], 0.0, nms_t),
        kernel_entry("msda_backward", "msda_backward.cu", "salience_detr_tpu/ops/deform_attn.py:666",
                     coco_launches["msda_backward"], bwd_err, bwd_t),
        # K3's ordered design (no float atomics), the train CLI's run 3 with
        # --use-deterministic-algorithms; timed on the captured flagship
        # encoder inputs; its bound counts the function's bytes, not the
        # design's workspace
        kernel_entry("msda_backward_ordered", "msda_backward.cu", "salience_detr_tpu/ops/deform_attn.py:666",
                     ordered_launches["msda_backward_ordered"], ordered_err, ordered_t),
        # K4: the train CLI's steps (train_coco run 1, train_coco_strong) and
        # the mixed criterion's step, timed on the captured costs at C = 1
        kernel_entry("assignment_forward", "hungarian.cu",
                     "salience_detr_tpu/ops/hungarian.py:36, :111",
                     coco_launches["hungarian"] + strong_launches["hungarian"] + mixed_launches["hungarian"],
                     0.0, hung_t),
        # K9 launches on the eval path with the NMS filter on (phase eval's run 1)
        kernel_entry("nms_keep_forward", "nms_keep.cu", "salience_detr_tpu/ops/nms.py:133",
                     eval_launches["nms_keep"], 0.0, keep_t),
        # B6 on the R50-DCN train path (phase dcn_train), timed at DCN_HOT;
        # library: F.grid_sample in f32 and its autograd backward
        kernel_entry("deform_conv_forward", "deform_conv.cu", "salience_detr_tpu/models/bricks/deform_conv.py:20",
                     dcn_train_launches["deform_conv"], dcn_fwd_err, dcn_t[0]),
        kernel_entry("deform_conv_backward", "deform_conv.cu", "salience_detr_tpu/models/bricks/deform_conv.py:20",
                     dcn_train_launches["deform_conv_backward"], dcn_bwd_err, dcn_t[1]),
        # the 16-bit DCN layer at F <= 128 (sampling, mask and the einsum of
        # :102-105) on the tensor cores, timed at DCN_HOT; bound at the bf16
        # tensor-core rate; no PyTorch call computes it (the
        # deform_conv_forward entry is also stages 3-4's forward and every
        # layer's recompute in backward)
        kernel_entry("deform_conv_fused", "deform_conv_gemm.cu",
                     "salience_detr_tpu/models/bricks/deform_conv.py:20, :102",
                     dcn_train_launches["deform_conv_fused"], fused_err, fused_t),
        # B8 on the int8 serve path (phase serve_q8), timed on a served
        # forward's encoder layer 0; no PyTorch call computes it.  The
        # quantisation is held bit-exact (phase msda_q8 raises otherwise)
        kernel_entry("msda_q8_quantize", "msda_q8.cu", "salience_detr_tpu/ops/deform_attn.py:910",
                     q8_launches["msda_q8_quantize"], 0.0, q8_t[0]),
        kernel_entry("msda_q8_sample", "msda_q8.cu", "salience_detr_tpu/ops/deform_attn.py:910",
                     q8_launches["msda_q8_sample"], q8_sample_err, q8_t[1]),
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
    print(f"wall_s_total={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
