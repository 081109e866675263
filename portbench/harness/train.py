"""Training: the program's ``Trainer`` steps on a pool of batches made on the
device from the seed and cycled; each step ends in a synchronisation.

Traffic parameters (``traffic/<mix>.json``, kind ``train``): ``batch``
images on the ``canvas``, ``max_gt`` gt slots an image; ``gt_counts``, one
list of ``batch`` counts for each batch of the pool (the seed shuffles each
batch's counts, so every seed does the same work); gt boxes with centres
uniform in ``centre`` and sides log-uniform in ``side`` (fractions of the
canvas), labels uniform over the classes; images standard normal (the
normalised pixels' scale).  The contrastive-denoising draws are made here
from the seed and handed to the program's step and to the reference alike.

The first ``check_steps`` steps run in set-up through the same step object
and call as the window's, with the program's choices recorded; their losses
and the parameters' change after them are the program's readings.

The window opens after set-up and closes when the first step that ends
``seconds`` or more after its opening ends: ``train_img_s`` is the images of
every step in it over its whole length.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from portbench.harness import check as checks, common


def make_pool(traffic: Dict, m: Dict, seed: int, device):
    """[(program batch, reference batch)] and [(program draws, reference
    draws)], one a batch of the pool."""
    from salience_detr_torch.models.bricks.criterion import Targets
    from salience_detr_torch.models.bricks.denoising import CDNDraws

    from portbench.reference.criterion import Targets as RefTargets
    from portbench.reference.denoising import CDNDraws as RefDraws, cdn_draws

    B, (H, W), M = traffic["batch"], traffic["canvas"], traffic["max_gt"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed % (2**63))
    pool, draws = [], []
    for counts in traffic["gt_counts"]:
        counts = [int(n) for n in rng.permutation(counts)]
        assert len(counts) == B and max(counts) <= M
        labels = np.zeros((B, M), np.int64)
        boxes = np.zeros((B, M, 4), np.float32)
        lo, hi = traffic["side"]
        for i, n in enumerate(counts):
            wh = np.exp(rng.uniform(np.log(lo), np.log(hi), (n, 2)))
            c0, c1 = traffic["centre"]
            ctr = rng.uniform(c0, c1, (n, 2))
            ctr = np.clip(ctr, wh / 2, 1 - wh / 2)
            labels[i, :n] = rng.integers(0, m["num_classes"], n)
            boxes[i, :n, :2], boxes[i, :n, 2:] = ctr, wh
        valid = np.arange(M)[None] < np.asarray(counts)[:, None]
        images = torch.randn((B, 3, H, W), generator=gen, device=device)
        t = [torch.from_numpy(x).to(device) for x in (labels, boxes, valid)]
        sizes = torch.tensor([[H, W]] * B, device=device)
        pool.append(({"images": images, "image_sizes": sizes, "targets": Targets(*t, tuple(counts))},
                     {"images": images, "image_sizes": sizes, "targets": RefTargets(*t, tuple(counts))}))
        d = cdn_draws(B, 2 * m["denoising_nums"], m["num_classes"], 0.5, gen, device)
        draws.append((CDNDraws(*d), RefDraws(*d)))
    return pool, draws


def _plain(v):
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


def run(cell: Dict, seed: int, seconds: float, trace: bool, device, t_start: float, port_cfg,
        state_dict, sync, trace_path=None) -> Dict:
    from salience_detr_torch.train import TRAIN_CONFIG, Trainer
    from salience_detr_torch.utils.config import Config

    from portbench.harness.recorder import ChoiceRecorder

    traffic, conf = cell["traffic"], cell["config"]
    m, tc = conf["model"], conf["train"]
    program_tc = Config(str(TRAIN_CONFIG)).to_dict()
    for k, v in tc.items():
        if k in program_tc and _plain(program_tc[k]) != _plain(v):
            raise SystemExit(f"the program's train config has {k}={program_tc[k]!r}, the benchmark's {v!r}")
    trainer = Trainer(port_cfg, device, seed=0, steps_per_epoch=tc["steps_per_epoch"])
    trainer.model.load_state_dict(state_dict, strict=True)
    pool, draws = make_pool(traffic, m, seed, device)
    names = {n: p for n, p in trainer.model.named_parameters() if p.requires_grad}
    n_check = traffic["check_steps"]
    prog = {"losses": [], "choices": []}
    with ChoiceRecorder() as recorder:
        for step in range(n_check):
            metrics = trainer.step(pool[step][0], draws=draws[step][0])
            sync()
            prog["losses"].append(float(metrics["loss"]))
            prog["choices"].append(recorder.take())
    prog["change"] = {n: float((p.detach() - state_dict[n]).norm()) for n, p in names.items()}
    sync()
    setup_s = time.perf_counter() - t_start

    attempted = failed = 0
    ends = []
    t0 = time.perf_counter()
    mark = t0 + seconds
    i = n_check
    while not ends or ends[-1] < mark:
        attempted += 1
        k = i % len(pool)
        i += 1
        try:
            trainer.step(pool[k][0], draws=draws[k][0])
            sync()
        except Exception:
            failed += 1
            if time.perf_counter() >= mark:
                break
            continue
        ends.append(time.perf_counter())
    window_s = (ends[-1] if ends else time.perf_counter()) - t0
    steps, B = len(ends), traffic["batch"]
    result = {"attempted": attempted, "failed": failed, "steps": steps, "images": steps * B,
              "window_s": window_s, "setup_s": setup_s, "step_s": common.quartiles(np.diff([t0, *ends])),
              "metrics": {"train_img_s": steps * B / window_s, "setup_s": setup_s},
              "images_by_canvas": {"x".join(map(str, traffic["canvas"])): steps * B}}
    if trace:
        from portbench.harness.trace import traced

        n = traffic["traced_steps"]
        batches = [(i + j) % len(pool) for j in range(n)]

        def work():
            for k in batches:
                trainer.step(pool[k][0], draws=draws[k][0])
                sync()

        t = traced(trainer.model, trace_path, work)
        result["traced"] = {"steps": n, "images": n * B, "slowdown": t["seconds"] / n / (window_s / max(steps, 1))}
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_batches = [pool[s][1] for s in range(n_check)]
    ref_draws = [draws[s][1] for s in range(n_check)]
    del pool, draws
    result["checks"] = checks.guarded(checks.train, cell, ref_batches, ref_draws, prog, state_dict, device)
    return result
