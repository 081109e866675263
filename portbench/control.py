"""Readings that set a cell's limits, at the cell's own size: the program's
numbers over many seeds (the lower reading), the control's (the upper) and,
for a training cell, the planted faults'.

    python3 portbench/control.py --workload <cell> --seeds S1 S2 ... --control-seeds C1 C2 C3
        [--faults half_batch altered_assignment]

The control is the reference put in the program's place and computed one
precision below the configuration's: every Linear and convolution fed
float8 (e4m3) operands (``reference/lowp.py``).  It makes its own choices,
which the float32 reference then follows and judges, as it follows the
program's.  A serving cell reads the calls a run would sample; a training
cell its first ``check_steps`` steps.  The benchmark's runs never run this.
Prints one JSON line per reading and a summary: per number, the largest
program reading and the smallest control and fault readings.

A training cell's lines also carry readings that are not compared (PERF.md):
the median and worst leaf's gap of the gradient AdamW got at step 1
(``grad_gap``, ``grad_gap_worst``), the worst leaf's gap of the change
(``update_gap_worst``) and, under ``look``, what makes the worst leaves
differ: the ratio of the two runs' clip scales, the worst change leaves with
their share of elements that AdamW's eps outweighs, the worst change gap
among leaves where it outweighs under half (``update_gap_worst_sign``), and
the leaves that set each run's global gradient norm.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import common  # noqa: E402

common.set_cache_dirs()


def serve_readings(cell, port_cfg, seeds, control_seeds, device):
    import numpy as np
    import torch
    from salience_detr_torch.inference import Predictor

    from portbench.harness import check, serve, weights
    from portbench.harness.recorder import ChoiceRecorder
    from portbench.reference import model as rm
    from portbench.reference.choices import Choices, choices
    from portbench.reference.lowp import float8_operands
    from portbench.reference.preprocess import preprocess

    traffic, m = cell["traffic"], cell["config"]["model"]
    skeleton = rm.build(m, "meta")
    predictor = Predictor(port_cfg, device=device, seed=0)
    out = []
    for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        sd = weights.make_state_dict(skeleton, seed, device)
        pool = serve.make_pool(traffic, seed)
        rng = np.random.default_rng(seed + 1)
        sample = sorted(rng.choice(traffic["sample_among"], traffic["sample_calls"], replace=False).tolist())
        kept = {}
        if kind == "program":
            predictor.model.load_state_dict(sd)
            with ChoiceRecorder() as rec:
                for i in sample:
                    host = serve.to_host(predictor(pool[i % len(pool)]))
                    kept[i] = (i % len(pool), host, rec.take())
        else:
            rm.exact_float32()
            low = rm.build(m, device)
            low.load_state_dict(sd)
            post = rm.postprocess(m)
            for i in sample:
                images, sizes, orig = preprocess(pool[i % len(pool)], m["min_size"], m["max_size"], device)
                c = Choices("record")
                with torch.no_grad(), choices(c), float8_operands():
                    o = low(images, sizes)
                    dets = post(o["pred_class"][-1], o["pred_coord"][-1], orig)
                host = {k: dets[k].cpu().numpy() for k in ("boxes", "scores", "labels")}
                kept[i] = (i % len(pool), host, [(k, v.cpu()) for k, v in c.records])
            del low
        numbers = check.serve_numbers(m, pool, kept, sd, device)
        out.append({"kind": kind, "seed": seed, **numbers})
        print(json.dumps(out[-1]), flush=True)
        del sd
        gc.collect()
        torch.cuda.empty_cache() if device.type == "cuda" else None
    return out


def program_step1(trainer, names, grad_norm: float, max_norm: float):
    """The program's step-1 gradient as AdamW got it (its first moment over
    1 - beta1): each leaf's norm, each leaf's share of elements under
    AdamW's eps, and each leaf's norm before the clip (over the clip's
    scale, from the program's global norm)."""
    group = trainer.optimizer.param_groups[0]
    beta1, eps = group["betas"][0], group["eps"]
    scale = min(1.0, max_norm / grad_norm) if grad_norm > 0 else 1.0
    grads, under, pre = {}, {}, {}
    for n, p in names.items():
        st = trainer.optimizer.state.get(p)
        if st and "exp_avg" in st:
            g = st["exp_avg"].float() / (1 - beta1)
            grads[n] = float(g.norm())
            under[n] = float((g.abs() < eps).float().mean())
            pre[n] = grads[n] / scale
    return grads, {"global_norm": grad_norm, "under_eps": under, "pre": pre}


def look(prog, ref_grads, ref_change, ref_made, max_norm: float):
    """The readings that are not compared, and what makes the worst leaves
    differ (see the module's docstring)."""
    import statistics

    from portbench.harness import check

    names = sorted(ref_grads)
    moving = check.moving(ref_grads)
    grads = check.leaf_gaps(prog["grads"], ref_grads, names)
    change = dict(zip(moving, check.leaf_gaps(prog["change"], ref_change, moving)))
    pm, rm_ = prog["made"], ref_made

    def scale(norm):
        return min(1.0, max_norm / norm) if norm > 0 else 1.0

    def setters(pre, k=3):
        total = sum(v * v for v in pre.values())
        return [[n, pre[n], pre[n] ** 2 / total] for n in sorted(pre, key=pre.get, reverse=True)[:k]]

    sign = [g for n, g in change.items() if rm_["under_eps"].get(n, 1.0) < 0.5]
    worst = sorted(change, key=change.get, reverse=True)[:3]
    return {
        "grad_gap": statistics.median(grads), "grad_gap_worst": max(grads),
        "update_gap_worst": max(change.values()),
        "look": {
            "update_gap_worst_sign": max(sign, default=0.0),
            "sign_leaves": len(sign), "moving_leaves": len(moving),
            "median_ref_change": statistics.median(ref_change[n] for n in moving),
            "global_norm": {"program": pm["global_norm"], "reference": rm_["global_norm"]},
            "clip_scale_ratio": scale(pm["global_norm"]) / scale(rm_["global_norm"]),
            "worst_change": [[n, change[n], prog["change"][n], ref_change[n], rm_["under_eps"].get(n),
                              pm["under_eps"].get(n)] for n in worst],
            "norm_setters": {"program": setters(pm["pre"]), "reference": setters(rm_["pre"])},
        },
    }


def train_readings(cell, port_cfg, seeds, control_seeds, faults, device):
    import torch
    from salience_detr_torch.train import Trainer

    from portbench.harness import check, train, weights
    from portbench.harness.recorder import ChoiceRecorder
    from portbench.reference import model as rm

    traffic, conf = cell["traffic"], cell["config"]
    m, tc = conf["model"], conf["train"]
    skeleton = rm.build(m, "meta")
    n = traffic["check_steps"]
    runs = ([("program", s) for s in seeds] + [("control", s) for s in control_seeds]
            + [(f, s) for f in faults for s in control_seeds])
    out = []
    for kind, seed in runs:
        sd = weights.make_state_dict(skeleton, seed, device)
        pool, draws = train.make_pool(traffic, m, seed, device)
        ref_batches = [pool[s][1] for s in range(n)]
        ref_draws = [draws[s][1] for s in range(n)]
        if kind == "control":
            losses, grads, change, _, records, made = check.reference_steps(m, tc, ref_batches, ref_draws, None, sd,
                                                                            device, lowp=True, look=True)
            prog = {"losses": losses, "grads": grads, "change": change, "choices": records, "made": made}
        else:
            trainer = Trainer(port_cfg, device, seed=0, steps_per_epoch=tc["steps_per_epoch"])
            trainer.model.load_state_dict(sd, strict=True)
            names = {k: p for k, p in trainer.model.named_parameters() if p.requires_grad}
            prog = {"losses": [], "choices": []}
            with plant(kind), ChoiceRecorder() as rec:
                for s in range(n):
                    metrics = trainer.step(pool[s][0], draws=draws[s][0])
                    prog["losses"].append(float(metrics["loss"]))
                    prog["choices"].append(rec.take())
                    if s == 0:
                        prog["grads"], prog["made"] = program_step1(trainer, names, float(metrics["grad_norm"]),
                                                                    tc["max_norm"])
            prog["change"] = {k: float((p.detach() - sd[k]).norm()) for k, p in names.items()}
            del trainer, names
        del pool, draws
        gc.collect()
        torch.cuda.empty_cache() if device.type == "cuda" else None
        losses, grads, change, numbers, _, made = check.reference_steps(m, tc, ref_batches, ref_draws,
                                                                        prog["choices"], sd, device, look=True)
        numbers.update(check.train_numbers(prog, losses, grads, change))
        numbers.update(look(prog, grads, change, made, tc["max_norm"]))
        out.append({"kind": kind, "seed": seed, **numbers})
        print(json.dumps(out[-1]), flush=True)
        del sd, ref_batches, ref_draws
        gc.collect()
        torch.cuda.empty_cache() if device.type == "cuda" else None
    return out


def plant(fault: str):
    """A fault planted in the program's train step while entered:
    ``half_batch`` trains on the first half of each batch (the losses' mean
    over those images only); ``altered_assignment`` alters the matcher's
    answer where it is produced: each image's matched queries move one gt on
    (the last gt's to the first), still one query a gt."""
    import contextlib

    if fault == "half_batch":
        from salience_detr_torch.models.bricks.criterion import Targets
        from salience_detr_torch.models.bricks.denoising import CDNDraws
        from salience_detr_torch.parallel import train_step as module

        name, real = "forward_and_loss", module.forward_and_loss

        def wrong(model, batch, draws, *args, **kwargs):
            h = batch["images"].shape[0] // 2
            t = batch["targets"]
            batch = {"images": batch["images"][:h], "image_sizes": batch["image_sizes"][:h],
                     "targets": Targets(t.labels[:h], t.boxes[:h], t.valid[:h], tuple(t.counts[:h]))}
            return real(model, batch, CDNDraws(*(x[:h] for x in draws)), *args, **kwargs)
    elif fault == "altered_assignment":
        import torch
        from salience_detr_torch.models.bricks import criterion as module

        name, real = "batched_assignment", module.batched_assignment

        def wrong(cost, valid):
            out = real(cost, valid).clone()
            for b in range(out.shape[0]):
                cols = torch.nonzero(valid[b]).flatten()
                if cols.numel() > 1:
                    out[b, cols] = out[b, cols.roll(1)]
            return out
    else:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def planted():
        setattr(module, name, wrong)
        try:
            yield
        finally:
            setattr(module, name, real)

    return planted()


def summary(rows):
    keys = [k for k in dict.fromkeys(k for r in rows for k in r) if k not in ("kind", "seed", "look")]
    out = {}
    for k in keys:
        prog = [r[k] for r in rows if r["kind"] == "program" and k in r]
        out[k] = {"program_max": max(prog) if prog else None}
        for kind in sorted({r["kind"] for r in rows} - {"program"}):
            vals = [r[k] for r in rows if r["kind"] == kind and k in r]
            out[k][f"{kind}_min"] = min(vals) if vals else None
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=["half_batch", "altered_assignment"])
    args = p.parse_args(argv)
    import torch
    from salience_detr_torch.inference import load_config

    if not torch.cuda.is_available():
        raise SystemExit("control.py reads at the cell's size on the card")
    cell = common.cell(args.workload)
    port_cfg = load_config(ROOT / cell["config"]["port_config"])
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if cell["traffic"]["kind"] == "serve":
        rows = serve_readings(cell, port_cfg, args.seeds, args.control_seeds, device)
    else:
        rows = train_readings(cell, port_cfg, args.seeds, args.control_seeds, args.faults, device)
    print(json.dumps({"summary": summary(rows), "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
