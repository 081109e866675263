"""Training configuration of the PyTorch port: the settings of
configs/train_config.py, training the port's flagship config.

    python -m salience_detr_torch.train --config-file configs/salience_detr_torch/train_config.py
"""

num_epochs = 12
batch_size = 16  # global batch (the reference uses 2/GPU x N GPUs)
num_workers = 8
print_freq = 50
starting_epoch = 0
max_norm = 0.1  # gradient clip

output_dir = None  # default: checkpoints/{model_name}/train/{time}

# dataset
coco_path = "data/coco"
train_transform = "detr"  # preset name, see salience_detr_torch/data/transforms.py
train_img_folder = f"{coco_path}/train2017"
train_ann_file = f"{coco_path}/annotations/instances_train2017.json"
test_img_folder = f"{coco_path}/val2017"
test_ann_file = f"{coco_path}/annotations/instances_val2017.json"

# model config file to train
model_path = "configs/salience_detr_torch/salience_detr_resnet50_800_1333.py"

resume_from_checkpoint = None
# ImageNet backbone .pth (torchvision names) loaded into the backbone at startup
backbone_weights = None
# a whole detector's .pth or checkpoint directory to fine-tune from
finetune_weights = None

# optimization
learning_rate = 1e-4
weight_decay = 1e-4
betas = (0.9, 0.999)
lr_milestones = [10]
lr_gamma = 0.1
warmup_factor = 1.0 / 1000
warmup_steps = 1000  # capped at steps_per_epoch
# parameter grouping: finetune_backbone_and_linear_projection (default),
# finetune_backbone_param, finetune_backbone_with_no_norm_weight_decay
param_dicts = "finetune_backbone_and_linear_projection"

# fixed canvases and target padding
train_canvas = (800, 1344)  # landscape; portrait images go on (1344, 800)
max_gt = 100  # gt slots per image
