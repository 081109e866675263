"""The port's train CLI (python -m salience_detr_torch.train) on the CPU, on
a written COCO-format split of ``.npy`` images with the tiny config of
tests/torch_port_common.py: a ``--dry-run-steps`` run trains, evaluates and
writes label_names.txt, the checkpoint with its metadata and the best
snapshots; a run stopped after epoch 0 and resumed trains epoch 1 exactly as
an unbroken run does (every step's metrics and the final weights equal); a
run resumed after a ``--dry-run-steps`` run replays epoch 0 from the saved
step, as the JAX ``train.py`` does (it starts at step // steps_per_epoch);
SIGTERM in the middle of an epoch writes a checkpoint and exits 0; a saved
checkpoint loads into the JAX model through the JAX package's own
``load_reference_checkpoint`` and both forwards agree at the full-model
tolerance; the default ``cuda`` device raises without a card."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from salience_detr_tpu.utils.weight_converter import load_reference_checkpoint, salience_detr_rules
from salience_detr_torch import train
from salience_detr_torch.models.factory import build_salience_detr
from salience_detr_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_port_model import check_slice_parity
from tests.torch_port_common import TINY_TORCH, build_jax_tiny, jax_variable_shapes, random_variables, write_coco_split
from tests.torch_port_common import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TRAIN_SIZES = [(96, 128), (128, 96), (70, 101), (101, 70), (96, 128), (80, 120), (60, 80)]
EVAL_SIZES = [(96, 128), (128, 96), (61, 47)]
NO_TENSORBOARD = "import sys; sys.modules['torch.utils.tensorboard'] = None; "


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    train_dir, train_ann = write_coco_split(root / "train", TRAIN_SIZES, seed=1, fmt="npy",
                                            counts=[3, 1, 0, 4, 2, 5, 1])
    val_dir, val_ann = write_coco_split(root / "val", EVAL_SIZES, seed=2, fmt="npy", counts=[2, 1, 3])
    model = root / "tiny_model.py"
    model.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                     f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    return dict(root=root, train_dir=train_dir, train_ann=train_ann, val_dir=val_dir, val_ann=val_ann, model=model)


def write_config(split, path, output_dir, **overrides):
    values = dict(
        num_epochs=1, batch_size=2, num_workers=2, print_freq=1, output_dir=str(output_dir),
        train_transform="detr", train_img_folder=str(split["train_dir"]), train_ann_file=str(split["train_ann"]),
        test_img_folder=str(split["val_dir"]), test_ann_file=str(split["val_ann"]), model_path=str(split["model"]),
        resume_from_checkpoint=True, learning_rate=1e-4, train_canvas=(96, 128), max_gt=6,
    )
    values.update(overrides)
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in values.items()))
    return str(path)


def cli(config, *extra):
    return ["--config-file", config, "--device", "cpu", "--mixed-precision", "no", "--seed", "0", *extra]


def step_metrics(output_dir):
    """{step: {metric: value}} of the JSONL tracker's train lines."""
    lines = [json.loads(x) for x in (Path(output_dir) / "metrics.jsonl").read_text().splitlines()]
    return {x["step"]: {k: v for k, v in x.items() if k.startswith("loss/")} for x in lines if "loss/loss" in x}


@pytest.fixture(scope="module")
def dry_run(split, tmp_path_factory):
    out = tmp_path_factory.mktemp("dry") / "out"
    config = write_config(split, out.parent / "train.py", out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # the JSONL tracker
        summary = train.main(cli(config, "--dry-run-steps", "2"))
    return out, summary


def test_dry_run_trains_evaluates_and_checkpoints(dry_run):
    out, summary = dry_run
    assert summary["epochs"] == [0] and summary["global_step"] == 2
    assert all(np.isfinite(v) for v in summary["metrics"].values())
    assert len(summary["stats"]) == 12 and all(np.isfinite(v) for v in summary["stats"].values())
    names = (out / "label_names.txt").read_text().splitlines()
    assert names == ["0", "c1", "c2", "c3"]
    ckpts = out / "checkpoints"
    meta = json.loads((ckpts / "metadata.json").read_text())
    assert meta["seed"] == 0 and meta["class_names"] == {"1": "c1", "2": "c2", "3": "c3"}
    for name in ("0.pth", "best_ap.pth", "best_ap50.pth"):
        assert (ckpts / name).exists(), name
    state = CheckpointManager(str(ckpts)).restore()
    assert (state["step"], state["epoch"], state["rng"]) == (2, 0, {"seed": 0})
    assert state["scaler"] is None and len(state["optimizer"]["state"]) > 300
    assert sorted(step_metrics(out)) == [0, 1]


def test_resumed_run_equals_an_unbroken_one(split, tmp_path):
    """Two epochs in one run, against one epoch, then a second run that
    resumes from its checkpoint: epoch 1's step metrics and the final
    weights and optimizer moments are equal."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        unbroken = tmp_path / "unbroken"
        kw = dict(train_transform="hflip")  # no resize: the host work stays small
        full = train.main(cli(write_config(split, tmp_path / "a.py", unbroken, num_epochs=2, **kw)))
        broken = tmp_path / "broken"
        first = train.main(cli(write_config(split, tmp_path / "b1.py", broken, num_epochs=1, **kw)))
        resumed = train.main(["--config-file", write_config(split, tmp_path / "b2.py", broken, num_epochs=2, **kw),
                              "--device", "cpu", "--mixed-precision", "no"])  # the seed comes from the checkpoint
    assert full["epochs"] == [0, 1] and first["epochs"] == [0] and resumed["epochs"] == [1]
    assert resumed["starting_epoch"] == 1 and resumed["seed"] == 0
    # an epoch has at most steps_per_epoch batches (the partial pools of
    # each orientation are dropped)
    want = {s: m for s, m in step_metrics(unbroken).items() if s >= first["global_step"]}
    got = step_metrics(broken)
    assert len(want) == full["global_step"] - first["global_step"] > 0
    assert {s: got[s] for s in want} == want
    assert resumed["metrics"] == full["metrics"] and resumed["stats"] == full["stats"]
    a = CheckpointManager(str(unbroken / "checkpoints")).restore()
    b = CheckpointManager(str(broken / "checkpoints")).restore()
    assert a["step"] == b["step"] == full["global_step"] == resumed["global_step"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)


def test_resume_after_a_dry_run_replays_the_epoch(dry_run, tmp_path):
    """The checkpoint of a 2-step dry run holds step 2 of an epoch of more
    steps: the resumed run starts at epoch 2 // steps_per_epoch = 0 and
    counts its steps on from 2."""
    out, first = dry_run
    assert first["steps_per_epoch"] > 2
    copy = tmp_path / "out"
    shutil.copytree(out, copy)
    config = (out.parent / "train.py").read_text().replace(repr(str(out)), repr(str(copy)))
    (tmp_path / "train.py").write_text(config)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        resumed = train.main(cli(str(tmp_path / "train.py"), "--dry-run-steps", "1"))
    assert resumed["starting_epoch"] == 0 and resumed["epochs"] == [0] and resumed["global_step"] == 3
    assert sorted(step_metrics(copy)) == [0, 1, 2]


def test_sigterm_checkpoints_and_exits_cleanly(split, tmp_path):
    out = tmp_path / "out"
    config = write_config(split, tmp_path / "train.py", out, num_epochs=50, train_transform="hflip")
    code = NO_TENSORBOARD + f"from salience_detr_torch.train import main; main({cli(config)!r})"
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"))
    log = out / "log.rank0.txt"
    try:
        deadline = time.time() + 120
        while not (log.exists() and "Epoch: [0] [0]" in log.read_text()):
            if proc.poll() is not None or time.time() > deadline:
                proc.kill()
                pytest.fail(f"training never started: {proc.communicate()[1][-3000:]}")
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    text = log.read_text()
    assert "preemption checkpoint saved at epoch 0" in text and "Test:" not in text
    state = CheckpointManager(str(out / "checkpoints")).restore()
    assert state["epoch"] == 0 and state["step"] >= 1
    assert json.loads((out / "checkpoints" / "metadata.json").read_text())["seed"] == 0


def test_checkpoint_loads_into_the_jax_model(dry_run, monkeypatch):
    """The checkpoint's model state dict through the JAX package's converter
    into the JAX tiny model: both eval forwards agree (proposal indices
    exactly, outputs at rtol 1e-3 / atol 1e-3)."""
    out, _ = dry_run
    path = str(out / "checkpoints" / "0.pth")
    jcfg, tcfg, jmodel = build_jax_tiny()
    template = random_variables(jax_variable_shapes(jmodel), seed=5)
    rules = salience_detr_rules(jcfg.backbone, tuple(jcfg.stage_with_dcn),
                                num_encoder_layers=jcfg.num_encoder_layers,
                                num_decoder_layers=jcfg.num_decoder_layers,
                                num_levels=jcfg.num_feature_levels, num_channel_mapper_convs=jcfg.num_feature_levels)
    variables = load_reference_checkpoint(template, path, rules=rules)
    trained = CheckpointManager(str(out / "checkpoints")).restore()["model"]
    tmodel, _ = build_salience_detr(tcfg, torch.device("cpu"))
    tmodel.load_state_dict(trained, strict=True)
    moved = tmodel.state_dict()["transformer.encoder.layers.0.linear1.weight"]
    fresh, _ = build_salience_detr(tcfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    assert not torch.equal(moved, fresh.state_dict()["transformer.encoder.layers.0.linear1.weight"])
    tmodel.eval()
    check_slice_parity(jmodel, variables, tmodel, monkeypatch)


def test_default_device_needs_cuda(split, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = write_config(split, tmp_path / "train.py", tmp_path / "out")
    with pytest.raises(RuntimeError, match="device cuda requested"):
        train.main(["--config-file", config])


def test_copypaste_and_unported_presets_raise_by_name(split, tmp_path):
    """``copypaste`` and ``strong_album`` are ported (they train in
    tests/test_torch_port_augment.py); a preset the JAX package does not
    have raises by name, with copy-paste on or off."""
    for i, copypaste in enumerate((True, False)):
        with pytest.raises(ValueError, match="unknown train_transform 'strong_albumm'"):
            train.main(cli(write_config(split, tmp_path / f"{i}.py", tmp_path / f"{i}", copypaste=copypaste,
                                        train_transform="strong_albumm")))
