"""Batched offline detection: one client in a closed loop hands the program's
``Predictor`` a call of requests (uint8 HWC images of one orientation) and
waits until the call's boxes, scores and labels are on the host.

Traffic parameters (``traffic/<mix>.json``, kind ``serve``): ``batch``
requests a call; ``pool`` calls made on the host in set-up and cycled,
``landscape`` of them landscape; request sizes (h, w) from ``sizes`` by
orientation, every size used as often in every seed's pool, in an order the
seed draws; ``sample_calls`` calls the check compares, drawn from the seed
among the first ``sample_among`` calls of the window.

The window opens after set-up and closes when the first call that ends
``seconds`` or more after its opening ends: ``serve_img_s`` is the images of
every call in it over its whole length, ``serve_p95_ms`` the 95th percentile
of those calls' latencies.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import check as checks, common

PREPROCESS = "portbench_call"


def make_pool(traffic: Dict, seed: int) -> List[List[np.ndarray]]:
    rng = np.random.default_rng(seed)
    batch, pool, landscape = traffic["batch"], traffic["pool"], traffic["landscape"]
    orient = ["landscape"] * landscape + ["portrait"] * (pool - landscape)
    calls = []
    for o in rng.permutation(orient):
        table = traffic["sizes"][o]
        sizes = [table[i % len(table)] for i in range(batch)]
        calls.append([rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in
                      (sizes[i] for i in rng.permutation(batch))])
    return calls


def canvas_of(call, cfg) -> str:
    from salience_detr_torch.inference import canvas_for

    h, w = canvas_for(*call[0].shape[:2], cfg)
    return f"{h}x{w}"


def to_host(dets) -> Dict[str, np.ndarray]:
    """The call's detections stacked per key and copied to the host."""
    return {k: torch.stack([d[k] for d in dets]).cpu().numpy() for k in ("boxes", "scores", "labels")}


def run(cell: Dict, seed: int, seconds: float, trace: bool, device, t_start: float, port_cfg,
        state_dict, sync, trace_path=None) -> Dict:
    from salience_detr_torch.inference import Predictor

    from portbench.harness.recorder import ChoiceRecorder

    traffic = cell["traffic"]
    pool = make_pool(traffic, seed)
    predictor = Predictor(port_cfg, state_dict=state_dict, device=device, seed=0)
    # warm up every canvas the pool uses, twice
    for call in [c for o in {canvas_of(c, port_cfg): c for c in pool}.values() for c in (o, o)]:
        to_host(predictor(call))
    sync()
    rng = np.random.default_rng(seed + 1)
    sample = set(rng.choice(traffic["sample_among"], traffic["sample_calls"], replace=False).tolist())
    setup_s = time.perf_counter() - t_start

    latencies, images, kept = [], 0, {}
    attempted = failed = 0
    t0 = c1 = time.perf_counter()
    mark = t0 + seconds
    i = 0
    while c1 < mark:
        call = pool[i % len(pool)]
        attempted += len(call)
        c0 = time.perf_counter()
        try:
            if i in sample:
                with ChoiceRecorder() as recorder:
                    host = to_host(predictor(call))
                kept[i] = (i % len(pool), host, recorder.take())
            else:
                to_host(predictor(call))
        except Exception:  # a call that fails counts against the run
            failed += len(call)
            c1 = time.perf_counter()
            i += 1
            continue
        c1 = time.perf_counter()
        latencies.append(c1 - c0)
        images += len(call)
        i += 1
    window_s = c1 - t0
    if not kept:  # fewer calls than the sample reaches: check the next one
        with ChoiceRecorder() as recorder:
            host = to_host(predictor(pool[i % len(pool)]))
        kept[i] = (i % len(pool), host, recorder.take())
    result = {"attempted": attempted, "failed": failed, "calls": len(latencies), "images": images,
              "window_s": window_s, "setup_s": setup_s, "step_s": common.quartiles(latencies)}
    lat = sorted(latencies)
    result["metrics"] = {
        "serve_img_s": images / window_s,
        "serve_p95_ms": 1e3 * lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] if lat else float("nan"),
        "setup_s": setup_s,
    }
    result["images_by_canvas"] = {}
    for j in range(len(latencies)):
        key = canvas_of(pool[j % len(pool)], port_cfg)
        result["images_by_canvas"][key] = result["images_by_canvas"].get(key, 0) + len(pool[j % len(pool)])
    if trace:
        from portbench.harness.trace import traced

        n = traffic["traced_calls"]

        def work():
            for j in range(n):
                with torch.profiler.record_function(PREPROCESS):
                    to_host(predictor(pool[j % len(pool)]))

        t = traced(predictor.model, trace_path, work)
        per_call = window_s / max(len(latencies), 1)
        result["traced"] = {"calls": n, "images": n * traffic["batch"], "slowdown": t["seconds"] / n / per_call}
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    del predictor
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = checks.guarded(checks.serve, cell, pool, kept, state_dict, device)
    return result
