"""FocalNet-L config of the PyTorch port: the fields of
configs/salience_detr/salience_detr_focalnet_large_lrf_800_1333.py
(upstream's FocalNet-Large-LRF, four focal levels, IN-22K).  Everything else
is the config default: exact per-head deformable sampling in the encoder and
the decoder (no location groups), bf16 compute on the GPU over float32
master weights.
"""

import torch

from salience_detr_torch.models.factory import SalienceDETRConfig

model_config = SalienceDETRConfig(
    backbone="focalnet_large_lrf_fl4",
    backbone_return_indices=(1, 2, 3),
    dtype=torch.bfloat16,
)
