"""A one-command rehearsal of the mAP-parity runbook (the twin of the JAX
tool ``tools/parity_runbook.py``).

The acceptance gate of the port is COCO val2017 mAP with a released
upstream checkpoint (R50, 12 epochs: AP 0.500, AP50 0.677, AP75 0.542).
Neither the checkpoint nor COCO is in the repository, so this tool runs the
whole path on stand-ins, so that the real run is the one command it prints:

1. builds the flagship at full dims in checkpoint-exact sampling (one
   location group a head in the encoder and the decoder, the layout of an
   upstream checkpoint) from the seeded init, and writes its complete state
   dict as an upstream-layout ``.pth`` (``{"model": state_dict}``);
2. counts the conversion: a fresh model of the same config loads the file
   back with ``strict=True`` (tensors loaded of the model's total, missing,
   unexpected, shapes that differ);
3. draws a synthetic val split at 800x1344 (``tools/synthetic.py``
   ``make_rich_dataset``: ``.npy`` images, which need no cv2, and a COCO
   json);
4. runs ``python -m salience_detr_torch.test --torch-checkpoint ...`` as a
   subprocess, which forces exact per-head sampling (K1 at G=8 in the
   encoder and the decoder, K2), loads the file ``strict=True`` and
   evaluates;
5. writes one JSON: coverage, the eval loop's img/s in exact mode, the AP
   line, the kernels the eval launched, the card's name and power limit,
   and the real-weights command.

    python -m salience_detr_torch.tools.parity_runbook [--n-images 16] [--batch-size 4]
        [--workdir parity_runbook] [--out parity_runbook/parity_runbook.json] [--device cuda|cpu]

What differs from the JAX tool: the weights are the port's own seeded init
written in the upstream layout (the JAX tool exports its flax init through
the inverse converter; the port's state dict has upstream's names, so no
converter runs); coverage comes from a strict load in this process (the
JAX CLI prints its converter's counts); img/s is a batch's images over the
median seconds a batch of the eval loop (its "Total time" line), not the
images over the loop's whole seconds, which hold the first batch's warm-up;
``--model-config`` and ``--canvas`` shrink the rehearsal for a CPU test.
It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Dict

import torch

from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.factory import build_salience_detr, exact_sampling
from salience_detr_torch.tools.cli_rehearsal import run_cli
from salience_detr_torch.tools.quality import REPO, platform, require_device
from salience_detr_torch.tools.synthetic import make_rich_dataset

REAL_CHECKPOINT = "salience_detr_resnet50_800_1333_coco_1x.pth"
REAL_ACCEPTANCE = "AP=0.500 AP50=0.677 AP75=0.542 (upstream README, R50 12 epochs)"


def real_weights_command(model_config: str) -> str:
    return (f"python -m salience_detr_torch.test --model-config {model_config} --torch-checkpoint "
            f"{REAL_CHECKPOINT} --coco-img data/coco/val2017 --coco-ann data/coco/annotations/instances_val2017.json")


def write_checkpoint(cfg, path: Path, seed: int) -> int:
    """The exact-sampling model's whole state dict from the seeded init,
    written as an upstream-layout ``.pth``; returns its tensor count."""
    model, _ = build_salience_detr(exact_sampling(cfg), torch.device("cpu"), torch.Generator().manual_seed(seed))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.save({"model": state}, path)
    return len(state)


def coverage(cfg, path: Path) -> Dict:
    """What a fresh model of the exact-sampling config takes from the file
    under ``strict=True``: tensors loaded of its total, and the keys missing,
    unexpected or of another shape (the strict load raises on any)."""
    from salience_detr_torch.test import load_state_dict

    state = load_state_dict(str(path))
    model, _ = build_salience_detr(exact_sampling(cfg), torch.device("cpu"), torch.Generator().manual_seed(1))
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    mismatched = sorted(k for k in set(want) & set(state) if tuple(want[k].shape) != tuple(state[k].shape))
    model.load_state_dict(state, strict=True)
    loaded = len(want) - len(missing) - len(mismatched)
    return {"loaded": loaded, "total": len(want), "share": loaded / len(want), "missing": missing,
            "unexpected": unexpected, "mismatched": mismatched, "strict": True}


def parse_eval_log(log: str, batch_size: int) -> Dict:
    """The AP line, the eval loop's seconds and its median seconds a batch
    (its "Total time" line), img/s from the median, and the kernels
    launched."""
    ap = re.findall(r"(AP=\d\.\d+ AP50=\d\.\d+ AP75=\d\.\d+[^\n]*)", log)
    loop = re.findall(r"Test: Total time: \S+ \((\d+\.\d+) s, (\d+) its, median (\d+\.\d+) s / it", log)
    launches = re.findall(r"kernel launches: ([^\n]*)", log)
    loop_s, batches, s_batch = (float(loop[-1][0]), int(loop[-1][1]), float(loop[-1][2])) if loop else (None,) * 3
    return {
        "ap_line": ap[-1].strip() if ap else None,
        "ap": float(re.search(r"AP=(\d\.\d+)", ap[-1]).group(1)) if ap else None,
        "eval_loop_s": loop_s,
        "eval_batches": batches,
        "eval_s_a_batch": s_batch,
        "exact_mode_img_s": batch_size / s_batch if s_batch else None,
        "launches": {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", launches[-1])} if launches else None,
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-config", default=str(DEFAULT_CONFIG.relative_to(REPO)))
    p.add_argument("--workdir", default=str(REPO / "parity_runbook"))
    p.add_argument("--out", default=None, help="the JSON (default: <workdir>/parity_runbook.json)")
    p.add_argument("--n-images", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--canvas", type=int, nargs=2, default=(800, 1344), metavar=("H", "W"))
    p.add_argument("--seed", type=int, default=0, help="the init seed of the written weights")
    p.add_argument("--timeout", type=int, default=3600, help="seconds for the eval CLI")
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = require_device(args.device)
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    cfg = load_config(args.model_config)

    pth = workdir / "synthesized_full_dims.pth"
    n_tensors = write_checkpoint(cfg, pth, args.seed)
    conversion = coverage(cfg, pth)
    img_dir, ann = make_rich_dataset(str(workdir / "val"), args.n_images, seed=0, canvas=tuple(args.canvas))
    cli_args = ["--model-config", args.model_config, "--torch-checkpoint", str(pth), "--coco-img", img_dir,
                "--coco-ann", ann, "--batch-size", str(args.batch_size), "--device", args.device]
    log, wall_s = run_cli("salience_detr_torch.test", cli_args, args.timeout)
    card = None
    if device.type == "cuda":
        from salience_detr_torch.timing import card_line

        card = card_line()
    result = {
        "command": "python -m salience_detr_torch.test " + " ".join(cli_args),
        "tensors_written": n_tensors,
        "conversion": conversion,
        "strict_load_in_cli": f"Loaded {pth}" in log,
        "n_images": args.n_images,
        "batch_size": args.batch_size,
        "canvas": list(args.canvas),
        "cli_wall_s": wall_s,
        **parse_eval_log(log, args.batch_size),
        "device": platform(device),
        "card": card,
        "real_weights_command": real_weights_command(args.model_config),
        "real_weights_acceptance": REAL_ACCEPTANCE,
    }
    result["passed"] = bool(result["strict_load_in_cli"] and conversion["share"] == 1.0
                            and result["ap_line"] is not None)
    out = Path(args.out) if args.out else workdir / "parity_runbook.json"
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    if not result["passed"]:
        raise SystemExit("parity_runbook: the strict load, the coverage or the AP line failed")
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
