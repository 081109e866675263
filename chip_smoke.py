#!/usr/bin/env python3
"""Drive the PyTorch port (salience_detr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of facts; any failure ends the script with a
non-zero exit and no result line:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: compiles salience_detr_torch/csrc/*.cu (nvcc, sm_90a);
3. msda: the MSDA kernel against its plain PyTorch version at the flagship's
   shapes (S=22323 over four levels; G=1 at Q=11403 and G=8 at Q=900, B=4),
   in float32 with TF32 off and in bfloat16, with times;
4. grid_nms: the grid-NMS kernel against its plain version at K=3600, B=4,
   exactly equal, with times;
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
   assignments, losses, gradients and updated parameters within tolerance;
10. train: the flagship R50 trains through the entry point's ``Trainer``
   (python -m salience_detr_torch.train) at B=4 on the 800x1344 canvas, bf16
   autocast, gts padded to 100 with 24, 7, 40 and 1 valid: one warm-up step
   through ``train_one_epoch``, then 3 timed steps whose launch counters must
   show 12 MSDA forward, 12 MSDA backward, 1 NMS and 7 assignment launches
   each; losses finite, trainable parameters moved, frozen ones not.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from salience_detr_torch import native
from salience_detr_torch.engine.train import train_one_epoch
from salience_detr_torch.inference import DEFAULT_CONFIG, Predictor, load_config, preprocess
from salience_detr_torch.models.bricks.attention import MultiScaleDeformableAttention
from salience_detr_torch.models.bricks.criterion import Targets, compute_matching_cost
from salience_detr_torch.models.bricks.denoising import cdn_draws
from salience_detr_torch.models.factory import SalienceDETRConfig
from salience_detr_torch.ops.deform_attn import (
    _backward_cuda,
    ms_deform_attn,
    ms_deform_attn_backward_plain,
    ms_deform_attn_plain,
)
from salience_detr_torch.ops.hungarian import batched_assignment, batched_assignment_plain
from salience_detr_torch.ops.nms import grid_nms_topk, grid_nms_topk_plain
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
# MSDA backward, (atol as a share of the output's largest magnitude, rtol).
# float32: the kernel adds d_value with atomics and sums d_locations and
# d_weights across lanes, in other orders than the plain version.  bfloat16:
# d_value is one f32 sum rounded once to bf16 on both sides (one ulp,
# 2**-7 relative); the other two are f32 sums of the same bf16 products.
BWD_TOL = {
    torch.float32: {"d_value": (1e-5, 1e-4), "d_locations": (1e-5, 1e-4), "d_weights": (1e-5, 1e-4)},
    torch.bfloat16: {"d_value": (1e-3, 1e-2), "d_locations": (1e-5, 1e-4), "d_weights": (1e-5, 1e-4)},
}
HUNGARIAN_COUNTS = [(24, 7, 40, 1), (100, 0, 57, 100)]
SMALL = dict(
    backbone="resnet18", embed_dim=32, num_classes=5, num_queries=24,
    num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=64,
    topk_sa=12, layer_filter_ratio=(1.0, 0.5), max_num_embedding=16,
    encoder_sampling_groups=1, min_size=96, max_size=128, select_box_nums_for_evaluation=20,
)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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


def phase_msda():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S = sum(h * w for h, w in LEVELS)
    B, H, C, L, P = 4, 8, 256, len(LEVELS), 4
    worst, timing = 0.0, None
    for G, Q in ((1, 11403), (8, 900)):
        value32 = torch.randn(B, S, C, generator=gen, device=dev)
        locs = torch.rand(B, Q, G, L, P, 2, generator=gen, device=dev) * 1.4 - 0.2
        weights = torch.rand(B, Q, H, L, P, generator=gen, device=dev)
        weights = weights / weights.sum((-2, -1), keepdim=True)
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
                timing = (ms, plain_ms)
    return worst, timing


def phase_grid_nms():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    S, K, num_out = sum(h * w for h, w in LEVELS), 3600, 900
    topk = torch.stack([torch.randperm(S, generator=gen, device=dev)[:K] for _ in range(4)])
    topk[1] = torch.arange(K, device=dev)  # a raster clump: long suppression chains
    topk = topk.to(torch.int32).contiguous()
    got = grid_nms_topk(topk, LEVELS, num_out)
    want = grid_nms_topk_plain(topk, LEVELS, num_out)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    ms = cuda_ms(lambda: grid_nms_topk(topk, LEVELS, num_out), 20)
    plain_ms = cuda_ms(lambda: grid_nms_topk_plain(topk, LEVELS, num_out), 3)
    print(f"grid_nms: B=4 K={K} S={S} num_out={num_out} mismatches={mismatches} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    if mismatches:
        raise AssertionError(f"grid_nms kernel differs from plain in {mismatches} entries")
    return 0.0, (ms, plain_ms)


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
    if launches != {"msda": layers * forwards, "grid_nms": forwards, "msda_backward": 0, "hungarian": 0}:
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


def compare_bwd(got, want, dtype, name):
    atol_rel, rtol = BWD_TOL[dtype][name]
    ref = want.float()
    err = (got.float() - ref).abs()
    scale = float(ref.abs().max())
    bad = int((err > atol_rel * scale + rtol * ref.abs()).sum())
    return float(err.max()), scale, bad, atol_rel, rtol


def phase_msda_backward():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    S = sum(h * w for h, w in LEVELS)
    B, H, C, L, P = 4, 8, 256, len(LEVELS), 4
    worst, timing = 0.0, None
    for G, Q in ((1, 11403), (8, 1100)):
        value32 = torch.randn(B, S, C, generator=gen, device=dev)
        locs = torch.rand(B, Q, G, L, P, 2, generator=gen, device=dev) * 1.4 - 0.2
        weights = torch.rand(B, Q, H, L, P, generator=gen, device=dev)
        weights = weights / weights.sum((-2, -1), keepdim=True)
        d_out32 = torch.randn(B, Q, C, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            value, d_out = value32.to(dtype), d_out32.to(dtype)
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
            parts = []
            for ref_name, refs in (("plain", plain), ("autograd", [x.grad for x in auto])):
                for name, g, r in zip(("d_value", "d_locations", "d_weights"), got, refs):
                    max_abs, scale, bad, atol_rel, rtol = compare_bwd(g, r, dtype, name)
                    parts.append(f"{name}_vs_{ref_name}={max_abs:.3e}(max|ref| {scale:.3e}, "
                                 f"atol {atol_rel}*max, rtol {rtol}, violations {bad})")
                    if bad:
                        raise AssertionError(
                            f"msda backward {name} disagrees with {ref_name} at G={G} {dtype}: "
                            f"{bad} elements"
                        )
                    worst = max(worst, max_abs)
            # the kernel's wrapper alone: scratch zeroing, launch, bf16 cast
            ms = cuda_ms(lambda: _backward_cuda(value, LEVELS, locs, weights, d_out), 10)
            plain_ms = cuda_ms(
                lambda: ms_deform_attn_backward_plain(value, LEVELS, locs, weights, d_out), 3
            )
            print(f"msda_backward: G={G} B={B} Q={Q} S={S} C={C} {str(dtype)[6:]} "
                  f"{' '.join(parts)} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if G == 1 and dtype == torch.bfloat16:  # the encoder's hot shape on the main path
                timing = (ms, plain_ms)
    return worst, timing


def phase_hungarian():
    from scipy.optimize import linear_sum_assignment

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    B, N, M, K = 4, 900, 100, 91
    timing = None
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
        cost = compute_matching_cost(logits, pred, targets)
        got = batched_assignment(cost, targets.valid)
        want = batched_assignment_plain(cost, targets.valid)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        host_cost, host_got = cost.cpu().numpy(), got.cpu().numpy()
        gaps = []
        for b in range(B):
            cols = np.flatnonzero(valid[b])
            r, c = linear_sum_assignment(host_cost[b][:, cols])
            ours = float(sum(host_cost[b][host_got[b][j], j] for j in cols))
            if len(set(host_got[b][cols].tolist())) != len(cols) or np.any(host_got[b][~valid[b]] != -1):
                raise AssertionError(f"image {b}: not a matching of the valid gts")
            gaps.append(abs(ours - float(host_cost[b][r, c].sum())))
        ms = cuda_ms(lambda: batched_assignment(cost, targets.valid), 10)
        plain_ms = cuda_ms(lambda: batched_assignment_plain(cost, targets.valid), 2)
        print(f"hungarian: B={B} N={N} M={M} valid={counts} mismatches={mismatches} "
              f"total_cost_gap_vs_scipy={max(gaps):.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if mismatches or max(gaps) > 1e-3:
            raise AssertionError(f"assignment kernel differs: {mismatches} entries, cost gap {max(gaps)}")
        timing = timing or (ms, plain_ms)
    return 0.0, timing


def small_train_step(device, counts=(3, 1)):
    """One train step of the small model on ``device`` from seed 6; returns
    (metrics, assignments, clipped gradients, parameters, buffers)."""
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
    matches, match = [], trainer.criterion.match

    def recording_match(*args):
        matches.append(match(*args))
        return matches[-1]

    trainer.criterion.match = recording_match
    metrics = trainer.step(batch, draws=draws)
    model = trainer.model
    return (
        {k: float(v) for k, v in metrics.items()},
        [m.cpu() for m in matches],
        {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None},
        {n: p.detach().cpu() for n, p in model.named_parameters()},
        {n: b.cpu() for n, b in model.named_buffers()},
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
          f"same_assignments={same_matches} max_loss_rel_err={loss_err:.3e} (rtol 1e-4) "
          f"grad_err/bound={grad_ratio:.3e} at {worst_grad} (bound 1e-3*max|g|+1e-6) "
          f"param_max_abs_err={param_err:.3e} (atol 1e-6) buffer_max_abs_err={buffer_err:.3e} (atol 1e-5) "
          f"same_grad_set={set(gpu[2]) == set(cpu[2])}")
    if not (same_matches and len(gpu[1]) == 3 and loss_err <= 1e-4 and grad_ratio <= 1.0
            and param_err <= 1e-6 and buffer_err <= 1e-5 and set(gpu[2]) == set(cpu[2])):
        raise AssertionError("the small train step on the card disagrees with the CPU step")


def phase_train(smi):
    cfg = load_config(DEFAULT_CONFIG)  # the flagship
    per_step = {"msda": 12, "msda_backward": 12, "grid_nms": 1, "hungarian": 7}
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


def main():
    smi = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    msda_err, msda_t = phase_msda()
    nms_err, nms_t = phase_grid_nms()
    phase_slice()
    serve_launches = phase_serve(smi)
    bwd_err, bwd_t = phase_msda_backward()
    hung_err, hung_t = phase_hungarian()
    phase_train_slice()
    train_launches = phase_train(smi)
    print(f"serve launches {serve_launches}; train launches {train_launches}")
    kernels = [
        {"name": "msda_forward", "route": "cuda", "source": "salience_detr_torch/csrc/msda.cu",
         "replaces": "salience_detr_tpu/ops/deform_attn.py:768", "launches": train_launches["msda"],
         "max_abs_err": msda_err, "ms": msda_t[0], "plain_ms": msda_t[1]},
        {"name": "grid_nms_forward", "route": "cuda", "source": "salience_detr_torch/csrc/grid_nms.cu",
         "replaces": "salience_detr_tpu/ops/nms.py:68", "launches": train_launches["grid_nms"],
         "max_abs_err": nms_err, "ms": nms_t[0], "plain_ms": nms_t[1]},
        {"name": "msda_backward", "route": "cuda",
         "source": "salience_detr_torch/csrc/msda_backward.cu",
         "replaces": "salience_detr_tpu/ops/deform_attn.py:666",
         "launches": train_launches["msda_backward"], "max_abs_err": bwd_err,
         "ms": bwd_t[0], "plain_ms": bwd_t[1]},
        {"name": "hungarian_forward", "route": "cuda", "source": "salience_detr_torch/csrc/hungarian.cu",
         "replaces": "salience_detr_tpu/ops/hungarian.py:36", "launches": train_launches["hungarian"],
         "max_abs_err": hung_err, "ms": hung_t[0], "plain_ms": hung_t[1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
