"""A tiny cell for the CPU tests: the configuration's fields at small widths
and a small canvas, its traffic and limits, and the program's config."""

from __future__ import annotations

import copy
import json

from portbench.harness.common import BENCH

TINY_MODEL = dict(
    embed_dim=32, num_classes=7, num_queries=30, num_feature_levels=4, num_encoder_layers=2,
    num_decoder_layers=2, num_heads=2, dim_feedforward=64, num_points=2, topk_sa=12,
    level_filter_ratio=[0.4, 0.8, 1.0, 1.0], layer_filter_ratio=[1.0, 0.6], max_num_embedding=50,
    encoder_sampling_groups=1, decoder_sampling_groups=None, backbone="resnet18",
    backbone_return_indices=[1, 2, 3], backbone_freeze_indices=[0], denoising_nums=10,
    min_size=64, max_size=96, select_box_nums_for_evaluation=20,
)
SERVE = {"kind": "serve", "batch": 2, "pool": 3, "landscape": 2,
         "sizes": {"landscape": [[48, 64], [40, 60]], "portrait": [[64, 48]]},
         "sample_calls": 1, "sample_among": 2, "traced_calls": 1}
TRAIN = {"kind": "train", "batch": 2, "canvas": [64, 96], "max_gt": 6, "gt_counts": [[1, 3], [2, 5], [4, 1], [6, 2]],
         "centre": [0.1, 0.9], "side": [0.05, 0.6], "check_steps": 3, "traced_steps": 1}


def tiny_cell(kind: str):
    """(cell, the program's config) of a tiny serve or train cell."""
    import torch
    from salience_detr_torch.models.factory import SalienceDETRConfig

    base = json.loads((BENCH / "configs" / "sdetr_r50.json").read_text())
    model = {**base["model"], **TINY_MODEL}
    conf = {**copy.deepcopy(base), "model": model, "flops": {}}
    fields = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v)
              for k, v in model.items()}
    port_cfg = SalienceDETRConfig(**fields, dtype=torch.float32)
    traffic = SERVE if kind == "serve" else TRAIN
    limits = json.loads((BENCH / "limits" / ("r50_serve_b16.json" if kind == "serve" else "r50_train_b16.json")).read_text())
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    name = "r50_serve_b16" if kind == "serve" else "r50_train_b16"
    cell = {"name": f"tiny_{kind}", "chips": 1, "config": conf, "traffic": copy.deepcopy(traffic), "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
            "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])]}
    return cell, port_cfg
