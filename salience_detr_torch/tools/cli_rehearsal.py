"""Rehearsal of the port's whole CLI stack on a detectable synthetic split:
``python -m salience_detr_torch.train``, then ``.test``, then
``.inference``, each as a subprocess (the port's twin of the JAX package's
``tools/cli_rehearsal.py``).  It proves that the shipped entry points (config
loading, the loader's workers, the device prefetch, the train step,
checkpoints, the eval CLI, the COCO evaluator, folder inference) run end to
end on the device.

    python -m salience_detr_torch.tools.cli_rehearsal [--epochs 40] [--min-ap50 0.30]
        [--seed 0] [--workdir DIR] [--device cuda]

64 training and 16 validation images of coloured rectangles
(``tools/synthetic.make_dataset``, seeds S and S + 500), 16 steps an epoch at
batch 4 on the 128x128 canvas, the small hybrid model (head-shared encoder,
exact decoder), bf16 on the card (float32 on the CPU).  The test CLI scores
the last epoch's checkpoint; the inference CLI writes the predictions of the
validation folder and, where cv2 is installed, draws them (``--show-dir``;
without cv2 ``inference_vis`` is null).  Prints
one JSON line {"train_ap50", "test_cli_ap50", "inference_preds",
"inference_vis", "epochs", "platform", "passed"} and exits 1 unless the test
CLI's AP50 reaches ``--min-ap50``, there are predictions and, where drawn,
one drawing an image.  ``--device`` defaults to cuda and the tool raises
without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

from salience_detr_torch.tools.quality import REPO, platform, require_device, write_model_config
from salience_detr_torch.tools.synthetic import CANVAS, NUM_CLASSES, make_dataset

TRAIN_CFG = """\
num_epochs = {epochs}
batch_size = 4
num_workers = 2
print_freq = 16
max_norm = 0.5
output_dir = r'{out_dir}'
train_transform = 'hflip'
train_img_folder = r'{train_img}'
train_ann_file = r'{train_ann}'
test_img_folder = r'{val_img}'
test_ann_file = r'{val_ann}'
model_path = r'{model_cfg}'
resume_from_checkpoint = None
learning_rate = 3e-4
lr_milestones = [1000]
warmup_steps = 50
train_canvas = {canvas}
max_gt = 8
"""


def cv2_installed() -> bool:
    """Whether cv2 can be imported here, without importing it."""
    try:
        return importlib.util.find_spec("cv2") is not None
    except ValueError:  # blocked through sys.modules["cv2"] = None
        return False


def last_ap50(log: str) -> float:
    """The last ``AP50=`` of a CLI's log (the evaluator's summary line)."""
    found = re.findall(r"AP50=([01]\.\d+)", log)
    return float(found[-1]) if found else float("nan")


def passed(test_ap50: float, n_preds: int, n_vis: Optional[int], n_val: int, min_ap50: float) -> bool:
    """The JAX tool's rule: the test CLI's AP50 reaches ``min_ap50``, the
    inference CLI predicted something and drew one file an image; without
    cv2 (``n_vis`` None) the drawing's term drops."""
    return bool(test_ap50 >= min_ap50 and n_preds > 0 and (n_vis is None or n_vis == n_val))


def run_cli(module: str, args: Sequence[str], timeout: float) -> Tuple[str, float]:
    """``python -m <module> <args>`` from the checkout's root (which leads
    the child's ``PYTHONPATH``); returns (stdout + stderr, seconds) and
    raises with the output's tail when it exits with another code than 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=str(REPO))
    log = r.stdout + r.stderr
    if r.returncode != 0:
        print(log[-4000:], file=sys.stderr)
        raise SystemExit(f"{module} failed rc={r.returncode}")
    return log, time.perf_counter() - t0


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=40, help="64 images / batch 4 = 16 steps an epoch")
    p.add_argument("--workdir", default=str(REPO / "build" / "cli_rehearsal"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-ap50", type=float, default=0.30)
    p.add_argument("--timeout", type=int, default=3000, help="seconds a CLI")
    p.add_argument("--n-train", type=int, default=64)
    p.add_argument("--n-val", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = require_device(args.device)
    dev = ["--device", args.device]

    os.makedirs(args.workdir, exist_ok=True)
    train_img, train_ann = make_dataset(os.path.join(args.workdir, "train"), args.n_train, args.seed)
    val_img, val_ann = make_dataset(os.path.join(args.workdir, "val"), args.n_val, args.seed + 500)
    model_cfg = write_model_config(
        os.path.join(args.workdir, "model.py"),
        backbone="resnet18", embed_dim=64, num_classes=NUM_CLASSES, num_queries=30,
        num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=96, topk_sa=16,
        layer_filter_ratio=(1.0, 0.5), denoising_nums=8, max_num_embedding=32,
        # the flagship's hybrid sampling: head-shared encoder, exact decoder
        encoder_sampling_groups=1, decoder_sampling_groups=None,
        backbone_freeze_indices=(), min_size=CANVAS[0], max_size=CANVAS[1],
        select_box_nums_for_evaluation=20,
    )
    out_dir = os.path.join(args.workdir, "out")
    shutil.rmtree(out_dir, ignore_errors=True)  # the last epoch's checkpoint must be this run's
    train_cfg = os.path.join(args.workdir, "train_config.py")
    with open(train_cfg, "w") as f:
        f.write(TRAIN_CFG.format(epochs=args.epochs, out_dir=out_dir, train_img=train_img, train_ann=train_ann,
                                 val_img=val_img, val_ann=val_ann, model_cfg=model_cfg, canvas=tuple(CANVAS)))

    precision = "bf16" if device.type == "cuda" else "no"
    _, train_s = run_cli("salience_detr_torch.train", ["--config-file", train_cfg, "--seed", str(args.seed),
                                                       "--mixed-precision", precision, *dev], args.timeout)
    with open(os.path.join(out_dir, "summary.json")) as f:
        train_ap50 = float(json.load(f)["stats"]["AP50"])  # the last epoch's evaluation
    from salience_detr_torch.utils.checkpoint import CheckpointManager

    checkpoints = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    checkpoint = os.path.join(checkpoints.directory, f"{checkpoints.latest_step()}.pth")

    log, test_s = run_cli("salience_detr_torch.test", [
        "--model-config", model_cfg, "--coco-img", val_img, "--coco-ann", val_ann,
        "--checkpoint", checkpoint, "--batch-size", "4", *dev], args.timeout)
    test_ap50 = last_ap50(log)

    pred_json = os.path.join(args.workdir, "inference_preds.json")
    vis_dir: Optional[str] = os.path.join(args.workdir, "vis") if cv2_installed() else None
    _, inference_s = run_cli("salience_detr_torch.inference", [
        "--image-dir", val_img, "--model-config", model_cfg, "--state-dict", checkpoint,
        "--save-results", pred_json, *(["--show-dir", vis_dir] if vis_dir else []), *dev], args.timeout)
    with open(pred_json) as f:
        n_preds = sum(len(e["boxes"]) for e in json.load(f))
    n_vis = len(os.listdir(vis_dir)) if vis_dir else None

    result = {
        "train_ap50": train_ap50,
        "test_cli_ap50": test_ap50,
        "inference_preds": n_preds,
        "inference_vis": n_vis,
        "epochs": args.epochs,
        "platform": platform(device),
        "passed": passed(test_ap50, n_preds, n_vis, args.n_val, args.min_ap50),
        "cli_s": {"train": train_s, "test": test_s, "inference": inference_s},
    }
    print(json.dumps(result))
    if not result["passed"]:
        raise SystemExit("cli rehearsal failed")
    return result


if __name__ == "__main__":
    main()
