"""The comparisons that decide ``correct``: the program's outputs against the
plain float32 reference, which follows the program's discrete choices and
judges each of them (``reference/choices.py``).  Every number comes back with
its limit (``limits/<cell>.json``); a run is correct when every number is
finite and at most its limit."""

from __future__ import annotations

import contextlib
import math
import statistics
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import model as rm
from portbench.reference.choices import Choices, choices


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(p.astype(np.float64), 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """The numbers that have a limit, each with it; the others go to
    standard error as readings that are not compared."""
    for k, v in numbers.items():
        if k not in limits:
            print(f"{k} (not compared): {v!r}", file=sys.stderr)
    return {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items() if k in limits}


def guarded(compare, *args) -> Dict[str, Dict[str, float]]:
    """``compare(*args)``; a comparison that raises is a failed check,
    reported with the error on standard error."""
    import traceback

    try:
        return compare(*args)
    except Exception:
        traceback.print_exc(file=sys.stderr)
        return {"check_error": {"value": float("inf"), "limit": 0.0}}


def passed(checked: Dict[str, Dict[str, float]]) -> bool:
    return bool(checked) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())


def choice_numbers(c: Choices) -> Dict[str, float]:
    """The judged choices: the worst top-k site's gap (``select_gap``), the
    mean of the sites' worst gaps (``select_mean``, steadier: one row whose
    scores lie within a bfloat16 step of each other moves the worst site
    alone), the NMS's mismatches and the worst assignment's gap."""
    topk = [v for k, v in c.gaps.items() if not k.startswith("assign")]
    out = {"select_gap": max(topk, default=0.0), "select_mean": statistics.fmean(topk) if topk else 0.0,
           "nms_mismatch": float(c.nms_mismatch)}
    assign = [v for k, v in c.gaps.items() if k.startswith("assign")]
    if assign:
        out["match_gap"] = max(assign)
    return out


@torch.no_grad()
def serve_numbers(m: Dict, calls: List, kept: Dict, state_dict, device) -> Dict[str, float]:
    """The sampled calls' detections against the reference forced on their
    choices.  ``kept``: {call: (index into ``calls``, host detections,
    recorded choices)}."""
    from portbench.reference.preprocess import preprocess

    rm.exact_float32()
    ref = rm.build(m, device)
    ref.load_state_dict(state_dict)
    post = rm.postprocess(m)
    worst = {"score_gap": 0.0, "box_gap": 0.0, "label_mismatch": 0.0, "select_gap": 0.0, "select_mean": 0.0,
             "nms_mismatch": 0.0}
    for _, (ci, host, forced) in sorted(kept.items()):
        images, sizes, orig = preprocess(calls[ci], m["min_size"], m["max_size"], device)
        c = Choices("force", forced)
        with choices(c):
            out = ref(images, sizes)
            dets = post(out["pred_class"][-1], out["pred_coord"][-1], orig)
        if c.unforced:
            print(f"call {ci}: no forced choice for {c.unforced}; the reference chose there", file=sys.stderr)
        scores = dets["scores"].cpu().numpy()
        boxes = dets["boxes"].cpu().numpy()
        labels = dets["labels"].cpu().numpy()
        scale = orig.max(1).values.float().cpu().numpy()[:, None, None]
        numbers = {
            "score_gap": float(np.abs(_logit(host["scores"]) - _logit(scores)).max()),
            "box_gap": float((np.abs(host["boxes"].astype(np.float64) - boxes) / scale).max()),
            "label_mismatch": float((host["labels"] != labels).sum()),
            **choice_numbers(c),
        }
        for k, v in numbers.items():
            worst[k] = max(worst[k], v) if math.isfinite(v) else float("inf")
    del ref
    return worst


def serve(cell: Dict, calls, kept, state_dict, device) -> Dict:
    if not kept:
        return {"sampled_calls": {"value": float("inf"), "limit": 0.0}}
    numbers = serve_numbers(cell["config"]["model"], calls, kept, state_dict, device)
    return judged(numbers, cell["limits"])


# --------------------------------------------------------------------- training

def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> List[float]:
    """Each leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and the median leaf's."""
    median = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names]


def reference_steps(m: Dict, tc: Dict, batches, draws, forced_steps, state_dict, device, lowp: bool = False,
                    look: bool = False):
    """The reference's first steps on the same batches and draws: (loss a
    step, norm of each leaf's gradient as AdamW gets it at step 1, norm of
    each leaf's change after the steps, the judged choices' numbers, the
    choices made, and with ``look`` the step-1 gradient's make-up: the
    global norm before the clip, each leaf's norm before it, and each leaf's
    share of elements that AdamW's eps outweighs after it).  With
    ``forced_steps`` None it makes its own choices and returns them as its
    records (the control)."""
    from portbench.reference.detector import compute_loss
    from portbench.reference.criterion import default_weight_dict
    from portbench.reference.lowp import float8_operands
    from portbench.reference.optim import build_optimizer, clip_grad_global_norm_, make_lr_schedule, set_lr

    rm.exact_float32()
    ref = rm.checkpointed(rm.build(m, device))
    ref.load_state_dict(state_dict)
    criterion, salience = rm.criteria(m)
    optimizer = build_optimizer(ref, tc["learning_rate"], tc["weight_decay"], tuple(tc["betas"]))
    schedule = make_lr_schedule(tc["learning_rate"], tc["steps_per_epoch"], tc["lr_milestones"], tc["lr_gamma"],
                                tc["warmup_factor"], min(tc["warmup_steps"], tc["steps_per_epoch"]))
    weights = default_weight_dict(m["num_decoder_layers"])
    params = [p for g in optimizer.param_groups for p in g["params"]]
    names = {id(p): n for n, p in ref.named_parameters()}
    losses, grads, numbers, records, made = [], {}, {}, [], {}
    for step, (batch, draw) in enumerate(zip(batches, draws)):
        c = Choices("record") if forced_steps is None else Choices("force", forced_steps[step])
        ref.train()
        optimizer.zero_grad(set_to_none=True)
        with choices(c), (float8_operands() if lowp else contextlib.nullcontext()):
            out = ref(batch["images"], batch["image_sizes"], batch["targets"], draw)
            loss = compute_loss(out, batch["targets"], batch["image_sizes"], criterion, salience,
                                float(max(sum(batch["targets"].counts), 1)), weights, m["denoising_nums"])
            total = torch.stack([v.float() for v in loss.values()]).sum()
            total.backward()
        del out, loss
        if step == 0 and look:
            made["pre"] = {names[id(p)]: float(p.grad.norm()) for p in params if p.grad is not None}
        norm = clip_grad_global_norm_(params, tc["max_norm"])
        if step == 0:
            grads = {names[id(p)]: float(p.grad.norm()) for p in params if p.grad is not None}
            if look:
                eps = optimizer.defaults["eps"]
                made["global_norm"] = float(norm)
                made["under_eps"] = {names[id(p)]: float((p.grad.abs() < eps).float().mean())
                                     for p in params if p.grad is not None}
        set_lr(optimizer, schedule(step))
        optimizer.step()
        losses.append(float(total.detach()))
        records.append([(k, v.cpu()) for k, v in c.records])
        for k, v in choice_numbers(c).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        if c.unforced:
            print(f"step {step}: no forced choice for {c.unforced}; the reference chose there", file=sys.stderr)
    change = {n: float((p.detach() - state_dict[n]).norm()) for n, p in ref.named_parameters() if p.requires_grad}
    del ref, optimizer
    return losses, grads, change, numbers, records, made


def moving(ref_grads: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others move under AdamW by round-off alone."""
    median = statistics.median(ref_grads.values())
    return sorted(n for n, g in ref_grads.items() if g >= 1e-3 * median)


def train_numbers(prog: Dict, ref_losses, ref_grads, ref_change) -> Dict[str, float]:
    """The program's readings (``losses``, ``change``) against the
    reference's: the worst step's relative loss gap, and the median moving
    leaf's gap of the change after the steps.  The worst leaf's change is
    not compared: leaves whose clipped gradient lies under AdamW's eps move
    in proportion to the clip's scale, which the few leaves that set the
    global norm make differ between any two precisions (PERF.md;
    ``control.py`` reads it)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref_losses))
    change = leaf_gaps(prog["change"], ref_change, moving(ref_grads))
    return {"loss_gap": loss_gap, "update_gap": statistics.median(change)}


def train(cell: Dict, batches, draws, prog: Dict, state_dict, device) -> Dict:
    m = cell["config"]["model"]
    tc = cell["config"]["train"]
    losses, grads, change, numbers, _, _ = reference_steps(m, tc, batches, draws, prog["choices"], state_dict, device)
    numbers.update(train_numbers(prog, losses, grads, change))
    return judged(numbers, cell["limits"])
