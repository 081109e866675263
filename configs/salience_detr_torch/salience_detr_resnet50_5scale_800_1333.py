"""R50 with C2-C5 features (strides 4, 8, 16, 32) config of the PyTorch
port: the fields of configs/salience_detr/salience_detr_resnet50_5scale_800_1333.py
(upstream's 5-scale R50 variant: return indices (0, 1, 2, 3),
max_num_embedding 500).  As in the JAX config, the neck keeps four feature
levels (num_feature_levels=4), so at the 800x1344 canvas the encoder sees
S = 67200 + 16800 + 4200 + 1050 = 89250 tokens.  Everything else is the
config default: exact per-head deformable sampling in the encoder and the
decoder, bf16 compute on the GPU over float32 master weights.
"""

import torch

from salience_detr_torch.models.factory import SalienceDETRConfig

model_config = SalienceDETRConfig(
    backbone="resnet50",
    backbone_return_indices=(0, 1, 2, 3),
    backbone_freeze_indices=(0,),
    max_num_embedding=500,
    dtype=torch.bfloat16,
)
