"""Swin-L config of the PyTorch port: the fields of
configs/salience_detr/salience_detr_swin_l_800_1333.py (upstream's Swin-L
IN-22K variant).  Everything else is the config default: exact per-head
deformable sampling in the encoder and the decoder (no location groups),
bf16 compute on the GPU over float32 master weights.
"""

import torch

from salience_detr_torch.models.factory import SalienceDETRConfig

model_config = SalienceDETRConfig(
    backbone="swin_l",
    backbone_return_indices=(1, 2, 3),
    dtype=torch.bfloat16,
)
