"""Shared helpers of the tests/test_torch_port_*.py files: the tiny hybrid
configuration in both packages, numerically sane random JAX variables made
with numpy, and exporting (a subtree of) them into the port's state-dict
layout through the weight converter's rules."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks.criterion import Targets
from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.utils.weight_converter import (
    export_torch_state_dict,
    flat_to_nested,
    flatten_variables,
)
from salience_detr_torch.models.factory import SalienceDETRConfig as TorchConfig

# the tiny-but-complete model of tests/test_full_model_parity.py, in the
# flagship's hybrid sampling mode: head-shared encoder (G=1), exact decoder
TINY = dict(
    backbone="resnet18", embed_dim=32, num_classes=5, num_queries=24,
    num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=64,
    topk_sa=12, level_filter_ratio=(0.4, 0.8, 1.0, 1.0), layer_filter_ratio=(1.0, 0.5),
    max_num_embedding=16, min_size=96, max_size=128, select_box_nums_for_evaluation=20,
)
TINY_TORCH = dict(TINY, encoder_sampling_groups=1, denoising_nums=4)
TINY_JAX = dict(TINY, shared_sampling_locations=True, decoder_sampling_groups=0, denoising_nums=4)
CANVAS = (96, 128)


def tiny_configs():
    return JaxConfig(**TINY_JAX), TorchConfig(**TINY_TORCH)


def jax_variable_shapes(model, canvas=CANVAS, batch=1):
    """Full variable tree (incl. the train-only denoising table) by
    eval_shape, which computes nothing."""
    M = 4
    targets = Targets(
        jnp.zeros((batch, M), jnp.int32), jnp.full((batch, M, 4), 0.5), jnp.ones((batch, M), bool)
    )
    return jax.eval_shape(
        lambda: model.init(
            {"params": jax.random.PRNGKey(0), "denoising": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)},
            jnp.zeros((batch, *canvas, 3)), jnp.full((batch, 2), 32, jnp.int32),
            targets, train=True,
        )
    )


def sane_random(flat_shapes, seed=0):
    """{path: shape} -> {path: float32 array} with values that keep a deep
    random network numerically tame: norm scales near 1, variances near 1,
    small biases, weights ~ N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in flat_shapes.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "mean":
            v = 0.01 * rng.normal(size=shape)
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif len(shape) <= 1:
            v = 0.02 * rng.normal(size=shape)
        else:
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) / np.sqrt(max(fan_in, 1))
        out[path] = v.astype(np.float32)
    return out


def random_variables(shapes_tree, seed=0):
    flat = flatten_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes_tree))
    return flat_to_nested(sane_random({k: v.shape for k, v in flat.items()}, seed))


def export_subtree(variables, rules, src_prefix):
    """Export ``variables`` through the rules whose torch name starts with
    ``src_prefix``; returns the state dict with the prefix stripped."""
    sub = [r for r in rules if r[0].startswith(src_prefix)]
    state, skipped = export_torch_state_dict(variables, sub)
    assert not skipped, skipped[:5]
    return {k[len(src_prefix):]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


def t(x):
    """numpy (or a JAX array) -> a torch tensor owning a copy of the data."""
    return torch.from_numpy(np.array(x, copy=True))


def build_jax_tiny():
    jcfg, tcfg = tiny_configs()
    model, *_ = build_jax(jcfg)
    return jcfg, tcfg, model


def write_coco_split(root, sizes, seed=0, max_boxes=6, crowd_every=0, fmt="png", num_classes=3, counts=None,
                     polygons=False):
    """A COCO-format split of random uint8 images of ``sizes`` (PNG through
    cv2, lossless, or ``.npy``) with ``counts[i]`` (by default 0..max_boxes)
    random boxes per image (every ``crowd_every``-th a crowd box when
    nonzero), categories 1..num_classes; with ``polygons`` each annotation
    also gets a segmentation of one or two random polygons around its box
    (fractional vertices, some past the image, some self-intersecting);
    returns (image dir, annotation path)."""
    import json
    from pathlib import Path

    rng = np.random.default_rng(seed)
    img_dir = Path(root) / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        name = f"{i:03d}.{fmt}"
        if fmt == "npy":
            np.save(img_dir / name, img)
        else:
            import cv2

            assert cv2.imwrite(str(img_dir / name), np.ascontiguousarray(img[:, :, ::-1]))
        images.append({"id": i + 1, "file_name": name, "height": h, "width": w})
        for _ in range(int(rng.integers(0, max_boxes + 1)) if counts is None else counts[i]):
            bw, bh = rng.uniform(0.05, 0.6) * w, rng.uniform(0.05, 0.6) * h
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            crowd = int(bool(crowd_every) and (len(anns) + 1) % crowd_every == 0)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.integers(1, num_classes + 1)),
                         "bbox": [float(x), float(y), float(bw), float(bh)], "area": float(bw * bh),
                         "iscrowd": crowd})
            if polygons:
                anns[-1]["segmentation"] = [
                    np.stack([rng.uniform(x - 0.1 * bw, x + 1.1 * bw, k), rng.uniform(y - 0.1 * bh, y + 1.1 * bh, k)],
                             1).reshape(-1).round(2).tolist()
                    for k in rng.integers(3, 9, int(rng.integers(1, 3)))
                ]
    ann = Path(root) / "annotations.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": c, "name": f"c{c}"} for c in range(1, num_classes + 1)]}))
    return img_dir, ann


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for a module that imports this fixture: the lane
    runs 6 test processes on 8 cores, where torch's default of one thread a
    core oversubscribes the CPU many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
