"""The last modules of the JAX package and their twins in the port, on the
CPU, inputs from numpy seeds:

* ``SegmentationPostProcess`` against the JAX one, resized up and down
  (``jax.image.resize`` bilinear, anti-aliased when it shrinks): the class
  maps are equal at every pixel where the JAX per-class stack has no tie;
  where it has one (two classes' masks made identical), both take the lower
  class, and any other pixel that differs is shown to be a near-tie of the
  JAX stack, within 1e-6;
* ``utils/file_io.PathManager`` against the JAX one on local paths and a
  registered handler, and importing it imports no TensorFlow;
* ``tools/export_torch_checkpoint``: a train checkpoint of the tiny model in
  exact sampling becomes a ``{"model": state}`` file equal key by key, bit
  for bit, to the JAX tool's ``export_torch_state_dict`` of the same
  weights; for the hybrid config the tool names the tensors that have no
  reference slot and leaves them out."""

import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks.post_process import SegmentationPostProcess as JaxSegPost
from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.utils import file_io as jax_file_io
from salience_detr_tpu.utils.weight_converter import export_torch_state_dict, salience_detr_rules
from salience_detr_torch.models.bricks.post_process import SegmentationPostProcess
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr, exact_sampling
from salience_detr_torch.tools import export_torch_checkpoint
from salience_detr_torch.utils import file_io
from salience_detr_torch.utils.checkpoint import CheckpointManager
from salience_detr_torch.weights import state_dict_from_jax
from tests.torch_port_common import TINY, TINY_TORCH, jax_variable_shapes, random_variables, t

REPO = Path(__file__).resolve().parent.parent


def seg_inputs(seed, B=2, Q=12, C=5, h=9, w=13):
    """Logits and mask logits; queries 0 and 1 take classes 0 and 3 with
    the same mask, and no other query takes either class, so that the two
    class means tie exactly at every pixel."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, Q, C)).astype(np.float32)
    logits[:, :, [0, 3]] -= 10.0
    logits[:, 0, 0] = logits[:, 1, 3] = 10.0
    masks = (3 * rng.normal(size=(B, Q, h, w))).astype(np.float32)
    masks[:, 1] = masks[:, 0]
    return logits, masks


@pytest.mark.parametrize("target_hw", [(37, 50), (5, 6)], ids=["upscale", "downscale"])
def test_segmentation_post_process_matches_jax(target_hw):
    logits, masks = seg_inputs(0)
    want = np.asarray(JaxSegPost()(jnp.asarray(logits), jnp.asarray(masks), target_hw))
    got = SegmentationPostProcess()(t(logits), t(masks), target_hw).numpy()
    assert got.shape == want.shape == (2, *target_hw)
    # the JAX per-class stack, resized, to read its ties
    cls = logits.argmax(-1)
    onehot = np.eye(5, dtype=np.float32)[cls]
    per_class = np.einsum("bqc,bqhw->bchw", onehot, 1 / (1 + np.exp(-masks))) / np.maximum(
        onehot.sum(1), 1)[..., None, None]
    stack = np.asarray(jax.image.resize(jnp.asarray(per_class), (2, 5, *target_hw), method="bilinear"))
    top2 = np.sort(stack, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    tie = stack[:, 0] == stack[:, 3]
    assert tie.all()  # classes 0 and 3 tie everywhere, exactly, in the JAX stack
    on_tie = stack.argmax(1) == 0
    assert on_tie.any() and (want[on_tie] == 0).all() and (got[on_tie] == 0).all()
    differ = got != want
    assert (gap[differ] < 1e-6).all(), gap[differ]
    assert differ.mean() < 0.01


class _MemoryHandler(file_io.PathHandler):
    prefixes = ("mem://",)

    def __init__(self):
        self.files = {}

    def exists(self, path):
        return path in self.files

    def ls(self, path):
        return sorted(k[len(path):].lstrip("/") for k in self.files if k.startswith(path))

    def mkdirs(self, path):
        self.files.setdefault(path, None)


def test_path_manager_matches_jax(tmp_path):
    for pm, root in ((file_io.PathManager, tmp_path / "port"), (jax_file_io.PathManager, tmp_path / "jax")):
        pm.mkdirs(str(root / "a" / "b"))
        with pm.open(str(root / "a" / "x.txt"), "w") as f:
            f.write("salience")
        pm.copy(str(root / "a" / "x.txt"), str(root / "a" / "b" / "y.txt"))
    for rel in ("a", "a/b"):
        assert file_io.PathManager.ls(str(tmp_path / "port" / rel)) == \
            jax_file_io.PathManager.ls(str(tmp_path / "jax" / rel))
    assert file_io.PathManager.open(str(tmp_path / "port" / "a" / "b" / "y.txt")).read() == "salience"
    assert file_io.PathManager.exists(str(tmp_path / "port" / "a")) and not file_io.PathManager.exists(
        str(tmp_path / "port" / "z"))
    handler = _MemoryHandler()
    file_io.PathManager.register_handler(handler)
    try:
        file_io.PathManager.mkdirs("mem://bucket/d")
        assert file_io.PathManager.exists("mem://bucket/d") and file_io.PathManager.ls("mem://bucket") == ["d"]
    finally:
        del file_io.PathManager._handlers["mem://"]
    assert file_io.PathManager._handlers is not jax_file_io.PathManager._handlers


def test_file_io_imports_no_tensorflow_or_jax():
    code = ("import sys; import salience_detr_torch.utils.file_io; "
            "print(sorted(m for m in ('tensorflow', 'jax', 'salience_detr_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, check=True)
    assert out.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def exact_variables():
    jmodel, *_ = build_jax(JaxConfig(**TINY, denoising_nums=4))
    return random_variables(jax_variable_shapes(jmodel), seed=8)


def train_checkpoint(directory, state, cfg):
    """A train CLI checkpoint of the port's model holding ``state``."""
    model, _ = build_salience_detr(cfg, torch.device("cpu"))
    model.load_state_dict(state, strict=True)
    CheckpointManager(str(directory)).save(3, {"model": model.state_dict(), "step": 3, "epoch": 1})


def test_checkpoint_export_equals_the_jax_tools(exact_variables, tmp_path):
    cfg = exact_sampling(SalienceDETRConfig(**TINY_TORCH))
    config = tmp_path / "exact.py"
    config.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig, exact_sampling\n"
                      f"model_config = exact_sampling(SalienceDETRConfig(**{TINY_TORCH!r}))\n")
    train_checkpoint(tmp_path / "ckpt", state_dict_from_jax(exact_variables, cfg), cfg)
    export_torch_checkpoint.main(["--model-config", str(config), "--checkpoint", str(tmp_path / "ckpt"),
                                  "--out", str(tmp_path / "w.pth")])
    got = torch.load(tmp_path / "w.pth", weights_only=True)["model"]
    want, skipped = export_torch_state_dict(exact_variables, salience_detr_rules(
        "resnet18", num_encoder_layers=2, num_decoder_layers=2, num_levels=4, num_channel_mapper_convs=4))
    assert not skipped and sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), np.asarray(v)), k


def test_checkpoint_export_names_the_hybrid_tensors_without_a_slot(tmp_path, caplog):
    cfg = SalienceDETRConfig(**TINY_TORCH)
    model, _ = build_salience_detr(cfg, torch.device("cpu"), torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), tmp_path / "hybrid.pth")
    config = tmp_path / "hybrid.py"
    config.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                      f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    logger = logging.getLogger("export_torch")
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger="export_torch"):
            state = export_torch_checkpoint.main(["--model-config", str(config), "--checkpoint",
                                                  str(tmp_path / "hybrid.pth"), "--out", str(tmp_path / "w.pth")])
    finally:
        logger.propagate = False
    no_slot = [f"transformer.encoder.layers.{i}.self_attn.sampling_offsets.{p}" for i in range(2)
               for p in ("bias", "weight")]
    assert not set(no_slot) & set(state)
    assert f"{len(no_slot)} tensors have no reference-layout slot" in caplog.text
    assert all(name in caplog.text for name in no_slot)
    reference = export_torch_checkpoint.reference_slots(cfg)
    assert set(state) == set(reference) - set(no_slot)
