"""Flagship config of the PyTorch port: Salience-DETR ResNet-50, 800x1333
eval geometry.

The same model as configs/salience_detr/salience_detr_resnet50_800_1333.py
(shared_sampling_locations=True, decoder_sampling_groups=0 there):
head-shared deformable sampling in the encoder (G = 1) and exact per-head
sampling in the decoder (G = H = 8), bf16 compute on the GPU (autocast over
float32 master weights).  The train fields (frozen backbone stages, CDN
slots, matching costs) are the JAX config's.
"""

import torch

from salience_detr_torch.models.factory import SalienceDETRConfig

model_config = SalienceDETRConfig(
    embed_dim=256,
    num_classes=91,
    num_queries=900,
    num_feature_levels=4,
    num_encoder_layers=6,
    num_decoder_layers=6,
    num_heads=8,
    dim_feedforward=2048,
    num_points=4,
    topk_sa=300,
    level_filter_ratio=(0.4, 0.8, 1.0, 1.0),
    layer_filter_ratio=(1.0, 0.8, 0.6, 0.6, 0.4, 0.2),
    backbone="resnet50",
    backbone_return_indices=(1, 2, 3),
    backbone_freeze_indices=(0,),
    denoising_nums=100,
    cost_class=2.0,
    cost_bbox=5.0,
    cost_giou=2.0,
    min_size=800,
    max_size=1333,
    select_box_nums_for_evaluation=300,
    encoder_sampling_groups=1,
    decoder_sampling_groups=None,
    dtype=torch.bfloat16,
)
