"""The modules under the port's train CLI, against the JAX package where it
has the same function: ``utils/config.py`` (the same values from the same
files; the port's train config is the JAX one but for the model it trains),
``utils/env.py`` (seeding, the SIGTERM flag, the report), the JSONL tracker,
``utils/checkpoint.py`` (retention, metadata, named snapshots,
``tolerant_update`` against the JAX one, ``load_torch_weights``),
``weights.py``'s backbone load against the JAX ``load_pretrained_backbone``
and its fine-tune load, the optimizer's three parameter groupings against
the JAX classifiers, and the train step's ``GradScaler`` path."""

import json
import os
import random
import signal
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from salience_detr_tpu.engine import optim as jax_optim
from salience_detr_tpu.utils import checkpoint as jax_checkpoint
from salience_detr_tpu.utils.config import Config as JaxConfig
from salience_detr_tpu.utils.weight_converter import flatten_variables, load_pretrained_backbone
from salience_detr_torch.engine.optim import PARAM_GROUPINGS, build_optimizer, make_lr_schedule, named_param_groups
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.bricks.criterion import default_weight_dict
from salience_detr_torch.models.factory import SalienceDETRConfig, build_criteria, build_salience_detr
from salience_detr_torch.parallel.train_step import make_train_step
from salience_detr_torch.train import synthetic_batch
from salience_detr_torch.utils import env
from salience_detr_torch.utils.checkpoint import (
    CheckpointManager,
    HighestCheckpoint,
    load_torch_weights,
    tolerant_update,
)
from salience_detr_torch.utils.config import Config
from salience_detr_torch.utils.tracker import TensorBoardTracker
from salience_detr_torch.weights import (
    converter_rules,
    load_backbone_weights,
    load_finetune_weights,
    state_dict_from_jax,
)
from tests.torch_port_common import CANVAS, TINY_TORCH, build_jax_tiny, jax_variable_shapes, random_variables
from tests.torch_port_common import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
JAX_TRAIN_CONFIG = ROOT / "configs" / "train_config.py"
PORT_TRAIN_CONFIG = ROOT / "configs" / "salience_detr_torch" / "train_config.py"


@pytest.mark.parametrize("path", [JAX_TRAIN_CONFIG, PORT_TRAIN_CONFIG])
def test_config_reads_as_the_jax_config(path):
    got, want = Config(str(path), batch_size=3), JaxConfig(str(path), batch_size=3)
    assert got.to_dict() == want.to_dict() and got.batch_size == 3
    assert got.pretty() == want.pretty() and ("lr_gamma" in got) and got.get("nope", 5) == 5
    with pytest.raises(AttributeError):
        got.nope
    with pytest.raises(FileNotFoundError):
        Config(str(path) + ".missing")


def test_port_train_config_is_the_jax_one_for_the_port_model():
    port, jax_cfg = Config(str(PORT_TRAIN_CONFIG)).to_dict(), Config(str(JAX_TRAIN_CONFIG)).to_dict()
    assert port.pop("model_path") == "configs/salience_detr_torch/salience_detr_resnet50_800_1333.py"
    jax_cfg.pop("model_path")
    assert port.pop("finetune_weights") is None  # train.py reads it with cfg.get: None there too
    assert port == jax_cfg
    assert (ROOT / Config(str(PORT_TRAIN_CONFIG)).model_path).resolve() == DEFAULT_CONFIG


def test_seed_everything_seeds_python_numpy_and_torch():
    draws = []
    for _ in range(2):
        assert env.seed_everything(123) == 123
        draws.append((random.random(), np.random.rand(), torch.rand(1).item()))
    assert draws[0] == draws[1]
    assert 0 <= env.seed_everything(None) < 2**31


def test_graceful_shutdown_turns_sigterm_into_a_flag():
    before = signal.getsignal(signal.SIGTERM)
    with env.GracefulShutdown() as stop:
        assert not stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop() and stop.requested
    assert signal.getsignal(signal.SIGTERM) is before
    info = env.collect_env_info()
    assert "torch:" in info and "python:" in info


def test_jsonl_tracker(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tracker = TensorBoardTracker(str(tmp_path))
    tracker.log({"loss/loss": 1.5}, 3)
    tracker.log({"val/AP": 0.25}, 0)
    tracker.close()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(x["step"], x.get("loss/loss"), x.get("val/AP")) for x in lines] == [(3, 1.5, None), (0, None, 0.25)]


def test_checkpoint_manager_retention_metadata_and_snapshots(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.restore() is None and ckpt.latest_step() is None and ckpt.read_metadata() is None
    for epoch in range(7):
        ckpt.save(epoch, {"model": {"w": torch.full((2,), float(epoch))}, "step": 10 * epoch}, {"seed": epoch})
    assert ckpt.steps() == [2, 3, 4, 5, 6]  # the 5 newest, as the JAX manager keeps
    assert ckpt.read_metadata() == {"seed": 6}
    assert ckpt.restore()["step"] == 60 and ckpt.restore(3)["step"] == 30
    assert torch.equal(ckpt.restore_weights()["model"]["w"], torch.full((2,), 6.0))
    best = HighestCheckpoint(ckpt)
    best.update({"v": 1}, 0.2, 0.5)
    best.update({"v": 2}, 0.1, 0.6)
    best.update({"v": 3}, 0.3, 0.4)
    assert ckpt.restore_named("best_ap") == {"v": 3} and ckpt.restore_named("best_ap50") == {"v": 2}
    assert not [p for p in os.listdir(ckpt.directory) if p.endswith(".tmp")]


def test_tolerant_update_and_torch_weights_as_jax(tmp_path):
    current = {"a": np.zeros((2, 3), np.float32), "b": np.zeros((4,), np.float32), "c": np.ones((1,), np.float32)}
    updates = {"a": np.ones((2, 3), np.float32), "b": np.ones((5,), np.float32), "x": np.ones((1,), np.float32)}
    nested = {"a": current["a"], "b": current["b"], "c": current["c"]}
    jax_merged, jax_applied, jax_mismatch = jax_checkpoint.tolerant_update(nested, updates)
    merged, applied, mismatch = tolerant_update({k: torch.from_numpy(v) for k, v in current.items()},
                                                {k: torch.from_numpy(v) for k, v in updates.items()})
    assert applied == jax_applied == 1 and mismatch == jax_mismatch
    for k, v in flatten_variables(jax.device_get(jax_merged)).items():
        np.testing.assert_array_equal(merged[k].numpy(), v)
    state = {"w": torch.arange(3.0)}
    for wrapper in ("model", "state_dict", None):
        path = tmp_path / f"{wrapper}.pth"
        torch.save({wrapper: state, "epoch": 1} if wrapper else state, path)
        got = load_torch_weights(str(path))
        want = jax_checkpoint.load_torch_weights(str(path))
        assert set(got) == set(want) == {"w"} and np.array_equal(got["w"].numpy(), want["w"])


def test_backbone_weights_load_as_the_jax_converter(tmp_path):
    """A torchvision-layout ImageNet file (bare names, ``module.`` prefix,
    an ``fc`` head the detector lacks): the port's backbone after the load
    equals the JAX model's after ``load_pretrained_backbone``, exported."""
    jcfg, tcfg, jmodel = build_jax_tiny()
    rng = np.random.default_rng(3)
    source, _ = build_salience_detr(tcfg, torch.device("cpu"), torch.Generator().manual_seed(9))
    imagenet = {"module." + k[len("backbone."):]: v + torch.from_numpy(rng.normal(size=v.shape)).to(v.dtype) * 0.1
                for k, v in source.state_dict().items() if k.startswith("backbone.")}
    imagenet["module.fc.weight"] = torch.zeros(1000, 512)
    path = tmp_path / "resnet18_imagenet.pth"
    torch.save(imagenet, path)

    variables = random_variables(jax_variable_shapes(jmodel), seed=0)
    want = state_dict_from_jax(load_pretrained_backbone(variables, str(path), backbone="resnet18"), tcfg)
    model, _ = build_salience_detr(tcfg, torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
    applied = load_backbone_weights(model, str(path))
    assert applied == len(imagenet) - 1
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(ValueError, match="applied 0 tensors"):
        torch.save({"fc.weight": torch.zeros(3)}, tmp_path / "wrong.pth")
        load_backbone_weights(model, str(tmp_path / "wrong.pth"))


def test_finetune_weights_skip_mismatched_heads(tmp_path):
    """A checkpoint of the same model with another class count: every tensor
    but the class heads (and the denoising label table) applies, from a file
    or a checkpoint directory."""
    cfg = SalienceDETRConfig(**TINY_TORCH)
    other, _ = build_salience_detr(SalienceDETRConfig(**dict(TINY_TORCH, num_classes=7)), torch.device("cpu"),
                                   torch.Generator().manual_seed(4))
    ckpt = CheckpointManager(str(tmp_path / "run"))
    ckpt.save(0, {"model": other.state_dict(), "step": 1})
    for source in (str(tmp_path / "run" / "0.pth"), str(tmp_path / "run")):
        model, _ = build_salience_detr(cfg, torch.device("cpu"))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        applied = load_finetune_weights(model, source)
        mismatched = {k for k, v in other.state_dict().items() if v.shape != before[k].shape}
        assert mismatched and applied == len(before) - len(mismatched)
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k] if k in mismatched else other.state_dict()[k]), k
    with pytest.raises(ValueError, match="no checkpoint"):
        load_finetune_weights(model, str(tmp_path / "missing_dir"))
    assert not (tmp_path / "missing_dir").exists()


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_param_groupings_match_jax(which):
    cfg = SalienceDETRConfig(**TINY_TORCH) if which == "tiny" else load_config(DEFAULT_CONFIG)
    model, _ = build_salience_detr(cfg, torch.device("cpu"))
    paths = {}
    for src, dst, _ in converter_rules(cfg):
        if dst.startswith("params/"):
            paths.setdefault(src, []).append(tuple(jax.tree_util.DictKey(c) for c in dst.split("/")[1:]))
    assert set(PARAM_GROUPINGS) == set(jax_optim.PARAM_GROUPINGS)
    for grouping, (classify, lr_mult, wd) in jax_optim.PARAM_GROUPINGS.items():
        groups = named_param_groups(model, grouping)
        assert len(groups) == sum(p.requires_grad for p in model.parameters())
        for name, group in groups.items():
            assert {classify(p) for p in paths[name]} == {group}, (grouping, name)
        _, port_lr, port_wd = PARAM_GROUPINGS[grouping]
        assert port_lr == lr_mult and port_wd == wd
        opt = build_optimizer(model, 1e-4, 1e-4, grouping=grouping)
        assert {(g["lr_mult"], g["weight_decay"]) for g in opt.param_groups} == {
            (lr_mult[g], 1e-4 if wd[g] else 0.0) for g in set(groups.values())}
    with pytest.raises(ValueError, match="unknown param_dicts"):
        build_optimizer(model, grouping="nope")


def test_grad_scaler_step_equals_the_unscaled_step():
    """The fp16 path's scale, unscale, clip and scaler step, in float32 on
    the CPU: the same update as the step without a scaler (the scale is a
    power of two), and the scaler steps."""
    cfg = SalienceDETRConfig(**TINY_TORCH)
    batch = synthetic_batch(np.random.default_rng(0), cfg.num_classes, (3, 1), CANVAS, 6, "cpu")
    results = []
    for scaler in (None, torch.amp.GradScaler("cpu", init_scale=2.0**10, growth_interval=1)):
        model, _ = build_salience_detr(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
        crit, sal = build_criteria(cfg)
        opt = build_optimizer(model)
        step = make_train_step(model, crit, sal, opt, make_lr_schedule(1e-4, 10), default_weight_dict(2),
                               scaler=scaler)
        metrics = step(batch, torch.Generator().manual_seed(1))
        results.append((metrics, {k: v.clone() for k, v in model.state_dict().items()}))
    (m0, s0), (m1, s1) = results
    assert scaler.get_scale() == 2.0**11  # a finite step grows the scale
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-6, atol=0)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-6, atol=1e-9)


def test_msda_takes_a_float16_value_in_float32():
    """fp16 autocast hands the MSDA a float16 value; the kernels take float32
    or bfloat16 rows, so the value is sampled in float32 and the result and
    the value's gradient come back in float16."""
    from salience_detr_torch.ops.deform_attn import ms_deform_attn

    rng = np.random.default_rng(0)
    shapes = [(6, 8), (3, 4)]
    S = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.normal(size=(2, S, 32)).astype(np.float16)).requires_grad_()
    locs = torch.from_numpy(rng.uniform(size=(2, 5, 1, 2, 4, 2)).astype(np.float32))
    weights = torch.from_numpy(rng.uniform(size=(2, 5, 4, 2, 4)).astype(np.float32))
    out = ms_deform_attn(value, shapes, locs, weights)
    assert out.dtype == torch.float16
    want = ms_deform_attn(value.detach().float().requires_grad_(), shapes, locs, weights)
    torch.testing.assert_close(out, want.half())
    out.float().sum().backward()
    assert value.grad.dtype == torch.float16 and bool(torch.isfinite(value.grad).all())
