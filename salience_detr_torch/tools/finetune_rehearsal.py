"""Custom-dataset fine-tune rehearsal through the port's train CLI (the
port's twin of the JAX package's ``tools/finetune_rehearsal.py``; upstream's
defect-detection workflow):

1. **pretrain** a small exact-sampling model on the 6-class rich scenes at
   256x320 (``tools/synthetic.make_rich_dataset``), standing in for a
   released checkpoint;
2. **take the .pth**: the pretrained model's state dict, which already has
   upstream's layout, saved with ``torch.save``;
3. **fine-tune** on a small split with the sparse category ids 11/57/89 and
   unseen colours (``make_defect_dataset``) from that ``.pth`` through the
   config's ``finetune_weights`` (``weights.load_finetune_weights``, the
   tolerant merge, which skips the tensors whose shape the class count
   changes), with the stem and stage 0 frozen and the fine-tune parameter
   groups;
4. **scratch**: the same fine-tune run without the weights;
5. **JSON-less eval**: the fine-tuned last checkpoint scored against an
   index built from the raw samples by ``utils.coco_utils.
   convert_to_coco_api``, not from the JSON.

    python -m salience_detr_torch.tools.finetune_rehearsal [--pretrain-epochs 40]
        [--finetune-epochs 12] [--workdir DIR] [--out FILE] [--device cuda]

Each training run is ``salience_detr_torch.train.main`` on a config file
the tool writes (bf16 on the card, float32 on the CPU), in this process.
Prints one JSON line {"pretrain_ap50", "finetune_ap50", "scratch_ap50",
"uplift", "jsonless_ap50", "platform", "passed", "merge_skipped"}, writes it
to ``--out`` when given, and exits 1 unless the fine-tune's AP50 is above
the scratch run's.  ``--device`` defaults to cuda and the tool raises
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, List

import torch

from salience_detr_torch.tools.quality import (
    REPO,
    evaluate_dataset,
    platform,
    require_device,
    write_model_config,
)
from salience_detr_torch.tools.synthetic import (
    DEFECT_CANVAS,
    DEFECT_IDS,
    RICH_NUM_CLASSES,
    make_defect_dataset,
    make_rich_dataset,
)

CANVAS = DEFECT_CANVAS
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
finetune_weights = {finetune_weights}
learning_rate = 3e-4
lr_milestones = [1000]
warmup_steps = 50
train_canvas = {canvas}
max_gt = 14
param_dicts = 'finetune_backbone_and_linear_projection'
"""


def model_fields(num_classes: int, freeze) -> Dict:
    return dict(
        backbone="resnet18", embed_dim=64, num_classes=num_classes, num_queries=30,
        num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=96, topk_sa=16,
        layer_filter_ratio=(1.0, 0.5), denoising_nums=8,
        max_num_embedding=48,  # >= the level-0 grid's max(32, 40) at 256x320
        # exact per-head sampling: the layout of upstream checkpoints
        encoder_sampling_groups=None, decoder_sampling_groups=None,
        backbone_freeze_indices=freeze, min_size=CANVAS[0], max_size=CANVAS[1],
        select_box_nums_for_evaluation=20,
    )


def run_train(workdir: str, name: str, fields: Dict, device: str, **cfg) -> Dict:
    """One run of the train CLI's ``main``; returns its summary with the
    output directory and model config path."""
    from salience_detr_torch import train

    out_dir = os.path.join(workdir, name)
    shutil.rmtree(out_dir, ignore_errors=True)  # the last checkpoint must be this run's
    os.makedirs(out_dir)
    model_cfg = write_model_config(os.path.join(out_dir, "model.py"), **fields)
    train_cfg = os.path.join(out_dir, "train_config.py")
    with open(train_cfg, "w") as f:
        f.write(TRAIN_CFG.format(out_dir=out_dir, model_cfg=model_cfg, canvas=tuple(CANVAS), **cfg))
    summary = train.main(["--config-file", train_cfg, "--seed", "0", "--device", device,
                          "--mixed-precision", "bf16" if torch.device(device).type == "cuda" else "no"])
    summary["model_cfg"] = model_cfg
    return summary


def skipped_by_merge(pth: str, fields: Dict) -> List[str]:
    """The tensors of ``pth`` that the tolerant merge skips for a model of
    ``fields``, by name."""
    from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
    from salience_detr_torch.utils.checkpoint import load_torch_weights, tolerant_update

    model, _ = build_salience_detr(SalienceDETRConfig(**fields), torch.device("cpu"))
    _, _, mismatches = tolerant_update(model.state_dict(), load_torch_weights(pth))
    return sorted(name for name, _, _ in mismatches)


def jsonless_ap50(out_dir: str, model_cfg: str, img_dir: str, ann_file: str, device: torch.device) -> float:
    """The AP50 of ``out_dir``'s last checkpoint against a
    ``convert_to_coco_api`` index built from the raw samples."""
    from salience_detr_torch.data.coco import CocoDetection
    from salience_detr_torch.inference import load_config
    from salience_detr_torch.models.factory import build_salience_detr
    from salience_detr_torch.parallel.train_step import make_eval_step
    from salience_detr_torch.utils.checkpoint import CheckpointManager
    from salience_detr_torch.utils.coco_utils import convert_to_coco_api

    cfg = load_config(model_cfg)
    model, post = build_salience_detr(cfg, device)
    restored = CheckpointManager(os.path.join(out_dir, "checkpoints")).restore_weights()
    if restored is None:
        raise SystemExit(f"no checkpoint under {out_dir}")
    model.load_state_dict(restored["model"], strict=True)
    dataset = CocoDetection(img_dir, ann_file)
    index = convert_to_coco_api(dataset)  # from the raw samples: no JSON behind the ground truth
    stats = evaluate_dataset(make_eval_step(model, post, cfg.dtype), dataset, cfg, device, 4, index=index)
    return float(stats["AP50"])


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default=str(REPO / "build" / "finetune_rehearsal"))
    p.add_argument("--pretrain-epochs", type=int, default=40)
    p.add_argument("--finetune-epochs", type=int, default=12)
    p.add_argument("--images", type=int, nargs=4, default=(64, 16, 32, 16),
                   metavar=("BASE_TRAIN", "BASE_VAL", "DEFECT_TRAIN", "DEFECT_VAL"))
    p.add_argument("--out", default=None, help="also write the JSON result here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = require_device(args.device)
    n_base, n_base_val, n_defect, n_defect_val = args.images

    os.makedirs(args.workdir, exist_ok=True)
    base_tr = make_rich_dataset(os.path.join(args.workdir, "base_train"), n_base, 0, CANVAS)
    base_va = make_rich_dataset(os.path.join(args.workdir, "base_val"), n_base_val, 500, CANVAS)
    dft_tr = make_defect_dataset(os.path.join(args.workdir, "defect_train"), n_defect, 7)
    dft_va = make_defect_dataset(os.path.join(args.workdir, "defect_val"), n_defect_val, 777)

    pre = run_train(args.workdir, "pretrain", model_fields(RICH_NUM_CLASSES, ()), args.device,
                    epochs=args.pretrain_epochs, train_img=base_tr[0], train_ann=base_tr[1],
                    val_img=base_va[0], val_ann=base_va[1], finetune_weights="None")

    # the pretrained weights as a .pth of upstream's layout
    from salience_detr_torch.utils.checkpoint import CheckpointManager

    pth = os.path.join(args.workdir, "pretrained_base.pth")
    torch.save(CheckpointManager(os.path.join(pre["output_dir"], "checkpoints")).restore_weights()["model"], pth)

    # num_classes covers the sparse ids; the stem and stage 0 frozen
    ft_fields = model_fields(max(DEFECT_IDS) + 1, (0,))
    ft_kw = dict(epochs=args.finetune_epochs, train_img=dft_tr[0], train_ann=dft_tr[1],
                 val_img=dft_va[0], val_ann=dft_va[1])
    ft = run_train(args.workdir, "finetune", ft_fields, args.device, finetune_weights=f"r'{pth}'", **ft_kw)
    sc = run_train(args.workdir, "scratch", ft_fields, args.device, finetune_weights="None", **ft_kw)
    jl = jsonless_ap50(ft["output_dir"], ft["model_cfg"], dft_va[0], dft_va[1], device)

    pre_ap50, ft_ap50, sc_ap50 = (float(s["stats"]["AP50"]) for s in (pre, ft, sc))
    result = {
        "pretrain_ap50": round(pre_ap50, 4),
        "finetune_ap50": round(ft_ap50, 4),
        "scratch_ap50": round(sc_ap50, 4),
        "uplift": round(ft_ap50 - sc_ap50, 4),
        "jsonless_ap50": round(jl, 4),
        "platform": platform(device),
        "passed": bool(ft_ap50 > sc_ap50),
        "merge_skipped": skipped_by_merge(pth, ft_fields),
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not result["passed"]:
        raise SystemExit("fine-tune rehearsal failed: the fine-tune's AP50 is not above the scratch run's")
    return result


if __name__ == "__main__":
    main()
