"""The port's evaluation entry point, ``python -m salience_detr_torch.test``,
on the CPU: it evaluates a COCO-format split of ``.npy`` images on an
explicit ``--device cpu``, its ``--save-results`` re-scores to the same
stats through its own ``--result-file`` and through root ``test.py``'s
``rescore_result_file``, it raises when the default ``cuda`` device is
missing, and it evaluates an upstream-layout state dict (exported from
exact-mode JAX variables) through ``--torch-checkpoint``, which a strict
load into the hybrid config refuses."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from salience_detr_tpu.data.coco import CocoIndex as JaxCocoIndex
from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_torch import test as port_test
from salience_detr_torch.models.factory import SalienceDETRConfig, exact_sampling
from salience_detr_torch.utils.coco_eval import METRIC_NAMES
from salience_detr_torch.weights import state_dict_from_jax
from tests.test_torch_port_eval import SIZES, write_split
from tests.torch_port_common import TINY, TINY_TORCH, jax_variable_shapes, random_variables

ROOT = Path(__file__).resolve().parent.parent


def root_test_module():
    """Root test.py (the JAX package's evaluation CLI), loaded by path."""
    spec = importlib.util.spec_from_file_location("root_test_cli", ROOT / "test.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    img_dir, ann = write_split(root, SIZES)
    cfg = root / "tiny_config.py"
    cfg.write_text(
        "from salience_detr_torch.models.factory import SalienceDETRConfig\n"
        f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n"
    )
    return img_dir, ann, cfg


def run_cli(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "salience_detr_torch.test", *map(str, args)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def metrics_line(stdout):
    lines = [line for line in stdout.splitlines() if " AP=" in line or line.startswith("AP=")]
    assert len(lines) == 1, stdout[-2000:]
    return lines[0][lines[0].index("AP="):]


def test_cli_on_explicit_cpu_and_rescore(split, tmp_path):
    img_dir, ann, cfg = split
    pred = tmp_path / "pred.json"
    proc = run_cli(["--coco-img", img_dir, "--coco-ann", ann, "--model-config", cfg, "--device", "cpu",
                    "--batch-size", "2", "--save-results", pred])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "COCO box matching route: native" in proc.stdout
    k = SalienceDETRConfig(**TINY_TORCH).select_box_nums_for_evaluation
    assert f"Saved {len(SIZES) * k} predictions" in proc.stdout  # the filters are off
    port = port_test.main(["--coco-img", str(img_dir), "--coco-ann", str(ann), "--result-file", str(pred)])
    jax_side = root_test_module().rescore_result_file(JaxCocoIndex(str(ann)), str(pred))
    assert list(port) == METRIC_NAMES == list(jax_side)
    assert all(abs(port[m] - jax_side[m]) <= 1e-12 for m in METRIC_NAMES), (port, jax_side)
    assert metrics_line(proc.stdout) == " ".join(f"{m}={v:.4f}" for m, v in port.items())


def test_cli_refuses_to_fall_back_to_cpu(split):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    img_dir, ann, cfg = split
    proc = run_cli(["--coco-img", img_dir, "--coco-ann", ann, "--model-config", cfg])
    assert proc.returncode != 0
    # the logger's exception hook reports an uncaught exception on stdout
    assert "torch.cuda.is_available() is False" in proc.stdout + proc.stderr


def test_cli_evaluates_an_upstream_layout_checkpoint(split, tmp_path):
    """A state dict of the tiny model in the reference's per-head sampling
    layout (the JAX package's default, exact mode) loads strictly into the
    hybrid config under ``--torch-checkpoint`` and evaluates; ``--checkpoint``
    loads a state dict into the config as it is, which refuses it."""
    img_dir, ann, cfg = split
    jmodel, *_ = build_jax(JaxConfig(**TINY, denoising_nums=4))
    variables = random_variables(jax_variable_shapes(jmodel), seed=3)
    exact = exact_sampling(SalienceDETRConfig(**TINY_TORCH))
    state = state_dict_from_jax(variables, exact)
    heads, levels, points = exact.num_heads, exact.num_feature_levels, exact.num_points
    assert state["transformer.encoder.layers.0.self_attn.sampling_offsets.weight"].shape[0] == \
        heads * levels * points * 2
    ckpt = tmp_path / "upstream.pth"
    torch.save(state, ckpt)
    proc = run_cli(["--coco-img", img_dir, "--coco-ann", ann, "--model-config", cfg, "--device", "cpu",
                    "--batch-size", "3", "--torch-checkpoint", ckpt])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "checkpoint-exact per-head sampling" in proc.stdout and f"Loaded {ckpt}" in proc.stdout
    stats = [float(kv.split("=")[1]) for kv in metrics_line(proc.stdout).split()]
    assert len(stats) == 12 and all(np.isfinite(stats))
    proc = run_cli(["--coco-img", img_dir, "--coco-ann", ann, "--model-config", cfg, "--device", "cpu",
                    "--checkpoint", ckpt])
    assert proc.returncode != 0 and "size mismatch" in proc.stdout + proc.stderr
