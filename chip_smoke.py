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
   the median of 3 timed B=4 forwards at the 800x1344 canvas.

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
from salience_detr_torch.inference import DEFAULT_CONFIG, Predictor, load_config, preprocess
from salience_detr_torch.models.factory import SalienceDETRConfig
from salience_detr_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_plain
from salience_detr_torch.ops.nms import grid_nms_topk, grid_nms_topk_plain

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
    cfg = SalienceDETRConfig(
        backbone="resnet18", embed_dim=32, num_classes=5, num_queries=24,
        num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=64,
        topk_sa=12, layer_filter_ratio=(1.0, 0.5), max_num_embedding=16,
        encoder_sampling_groups=1,
        min_size=96, max_size=128, select_box_nums_for_evaluation=20,
    )
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
    if launches != {"msda": layers * forwards, "grid_nms": forwards}:
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


def main():
    smi = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    msda_err, msda_t = phase_msda()
    nms_err, nms_t = phase_grid_nms()
    phase_slice()
    launches = phase_serve(smi)
    kernels = [
        {"name": "msda_forward", "route": "cuda", "source": "salience_detr_torch/csrc/msda.cu",
         "replaces": "salience_detr_tpu/ops/deform_attn.py:768", "launches": launches["msda"],
         "max_abs_err": msda_err, "ms": msda_t[0], "plain_ms": msda_t[1]},
        {"name": "grid_nms_forward", "route": "cuda", "source": "salience_detr_torch/csrc/grid_nms.cu",
         "replaces": "salience_detr_tpu/ops/nms.py:68", "launches": launches["grid_nms"],
         "max_abs_err": nms_err, "ms": nms_t[0], "plain_ms": nms_t[1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
