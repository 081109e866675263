"""R50-DCN config of the PyTorch port: the flagship
(salience_detr_resnet50_800_1333.py beside this file) with modulated
deformable convs (DCNv2, one deformable group) in conv2 of every block of
ResNet stages 2-4 (c3-c5): 13 DCN layers, 4 + 6 + 3, the first of each stage
at stride 2.  The placement is mmdetection's
configs/dcnv2/faster-rcnn_r50-mdconv-c3-c5_fpn_1x_coco.py.  Its JAX
counterpart is the JAX flagship SalienceDETRConfig with
stage_with_dcn=(False, True, True, True).
"""

import dataclasses
from pathlib import Path

from salience_detr_torch.inference import load_config

model_config = dataclasses.replace(
    load_config(Path(__file__).resolve().parent / "salience_detr_resnet50_800_1333.py"),
    stage_with_dcn=(False, True, True, True),
)
