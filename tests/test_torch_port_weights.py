"""The port's weights bridge against the JAX package's weight converter: the
port keeps its own copy of the converter's rules (``weight_rules.py``), which
must stay equal to the JAX package's, and must never load a file of the JAX
package."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.utils import weight_converter as jax_wc
from salience_detr_torch import weight_rules
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.factory import SalienceDETRConfig
from salience_detr_torch.weights import converter_rules, state_dict_from_jax
from tests.torch_port_common import (
    TINY_TORCH,
    build_jax_tiny,
    jax_variable_shapes,
    random_variables,
)

ROOT = Path(__file__).resolve().parent.parent


def jax_rules(cfg: SalienceDETRConfig):
    return jax_wc.salience_detr_rules(
        cfg.backbone,
        tuple(cfg.stage_with_dcn),
        num_encoder_layers=cfg.num_encoder_layers,
        num_decoder_layers=cfg.num_decoder_layers,
        num_levels=cfg.num_feature_levels,
        num_channel_mapper_convs=cfg.num_feature_levels,
    )


CONFIGS = {
    "flagship": lambda: load_config(DEFAULT_CONFIG),
    "flagship_dcn": lambda: load_config(DEFAULT_CONFIG.parent / "salience_detr_resnet50_dcn_800_1333.py"),
    "tiny": lambda: SalienceDETRConfig(**TINY_TORCH),
    "tiny_dcn": lambda: SalienceDETRConfig(**TINY_TORCH, stage_with_dcn=(False, True, True, True)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rules_equal_the_jax_converters(name):
    cfg = CONFIGS[name]()
    assert converter_rules(cfg) == jax_rules(cfg)


HELPERS = [
    ("_conv", ("a.b", "a/b")),
    ("_linear", ("a.b", "a/b")),
    ("_ln", ("a.b", "a/b")),
    ("_frozen_bn", ("a.b", "a/b")),
    ("_bn", ("a.b", "a/b")),
    ("_msdeform", ("a.b", "a/b")),
    ("_mlp", ("a.b", "a/b", 3)),
    ("_conv_bn_act", ("a.b", "a/b")),
    ("_se", ("a.b", "a/b")),
    ("_repvgg_block", ("a.b", "a/b", True)),
    ("_csp_layer", ("a.b", "a/b", 2, True)),
    ("_repnet_rules", ("a.b", "a/b", 4)),
    ("_dcn_pack", ("a.b", "a/b")),
]


@pytest.mark.parametrize("name,args", HELPERS, ids=[h[0] for h in HELPERS])
def test_rule_helpers_equal_the_jax_converters(name, args):
    assert getattr(weight_rules, name)(*args) == getattr(jax_wc, name)(*args)


def test_mha_and_resnet_rules_equal_the_jax_converters():
    assert weight_rules._mha("a.b", "a/b") == jax_wc._mha("a.b", "a/b", 256)
    for layers, bottleneck in (((2, 2, 2, 2), False), ((3, 4, 6, 3), True), ((3, 4, 23, 3), True)):
        assert weight_rules._resnet_rules(layers, bottleneck) == jax_wc._resnet_rules(layers, bottleneck)


@pytest.mark.parametrize("kind,shape", [("copy", (5,)), ("conv", (3, 3, 4, 6)), ("linear", (7, 5)),
                                        ("dcn_kernel", (9, 4, 6))])
def test_invert_transform_equals_the_jax_converters(kind, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(weight_rules._invert_transform(x, kind), jax_wc._invert_transform(x, kind))
    with pytest.raises(ValueError):
        weight_rules._invert_transform(x, "inproj_w0")


def flagship_variables():
    cfg = load_config(DEFAULT_CONFIG)
    jmodel, *_ = build_jax(JaxConfig(shared_sampling_locations=True, decoder_sampling_groups=0))
    return cfg, random_variables(jax_variable_shapes(jmodel, canvas=(64, 64)), seed=1)


def tiny_variables():
    _, tcfg, jmodel = build_jax_tiny()
    return tcfg, random_variables(jax_variable_shapes(jmodel), seed=0)


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_state_dict_equals_the_jax_export(which):
    """``state_dict_from_jax`` against the JAX converter's
    ``export_torch_state_dict``, array for array, bit for bit."""
    cfg, variables = tiny_variables() if which == "tiny" else flagship_variables()
    want, skipped = jax_wc.export_torch_state_dict(variables, jax_rules(cfg))
    assert not skipped
    got = state_dict_from_jax(variables, cfg)
    assert set(got) == set(want)
    for key, ref in want.items():
        assert tuple(got[key].shape) == ref.shape, key
        np.testing.assert_array_equal(got[key].numpy(), ref.astype(np.float32), err_msg=key)


def test_export_reports_missing_targets_as_the_jax_converter():
    cfg, variables = tiny_variables()
    del variables["params"]["denoising_generator"]
    rules = jax_rules(cfg)
    assert weight_rules.export_torch_state_dict(variables, rules)[1] == jax_wc.export_torch_state_dict(
        variables, rules
    )[1] != []
    with pytest.raises(ValueError, match="lack"):
        state_dict_from_jax(variables, cfg)


def test_bridge_loads_no_file_of_the_jax_package(tmp_path):
    """A fresh process imports every module of the port (the data, utils and
    engine modules and the evaluation entry point among them), exports JAX
    variables (saved by this process as numpy) through the bridge and loads
    them strictly into the tiny model, builds every backbone family's rules
    and model (on the meta device), builds the evaluator's native
    library, and evaluates a COCO-format split through the entry point and
    re-scores its predictions; it has loaded no module from
    salience_detr_tpu/ and not JAX, and opened no file there."""
    from tests.test_torch_port_eval import SIZES, write_split

    _, variables = tiny_variables()
    img_dir, ann = write_split(tmp_path, SIZES)
    cfg_file = tmp_path / "tiny_config.py"
    cfg_file.write_text(
        "from salience_detr_torch.models.factory import SalienceDETRConfig\n"
        f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n"
    )
    split = ["--coco-img", str(img_dir), "--coco-ann", str(ann)]
    pred = str(tmp_path / "pred.json")
    flat = jax_wc.flatten_variables(variables)
    np.savez(tmp_path / "vars.npz", **{k.replace("/", "|"): v for k, v in flat.items()})
    script = f"""
import importlib, os, pkgutil, sys
from pathlib import Path
jax_root = {str(ROOT / "salience_detr_tpu")!r}
touched = []
def audit(event, args):  # every file the process opens, compiles or imports
    for a in args:
        if isinstance(a, (str, bytes, os.PathLike)) and os.fsdecode(a).startswith(jax_root):
            touched.append((event, os.fsdecode(a)))
sys.addaudithook(audit)
import numpy as np
import torch
import salience_detr_torch
for mod in pkgutil.walk_packages(salience_detr_torch.__path__, "salience_detr_torch."):
    importlib.import_module(mod.name)
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.weights import state_dict_from_jax
tree = {{}}
with np.load({str(tmp_path / "vars.npz")!r}) as npz:
    for key in npz.files:
        node = tree
        *parents, leaf = key.split("|")
        for p in parents:
            node = node.setdefault(p, {{}})
        node[leaf] = npz[key]
cfg = SalienceDETRConfig(**{TINY_TORCH!r})
model, _ = build_salience_detr(cfg, torch.device("cpu"))
model.load_state_dict(state_dict_from_jax(tree, cfg), strict=True)
from salience_detr_torch import weight_rules
for arch in ("resnext50_32x4d", "conv_l", "swin_l", "swin_v2_t", "focalnet_large_lrf_fl4", "vit_b",
             "eva_02_vit_b_4attn_1024"):  # every backbone family's rules and its model
    weight_rules.salience_detr_rules(arch)
    with torch.device("meta"):
        build_salience_detr(SalienceDETRConfig(**dict({TINY_TORCH!r}, backbone=arch)), torch.device("meta"))
from salience_detr_torch import native
from salience_detr_torch import test as port_test
native.cocoeval_lib()
stats = port_test.main({split!r} + ["--model-config", {str(cfg_file)!r}, "--device", "cpu",
                       "--batch-size", "2", "--save-results", {pred!r}])
assert port_test.main({split!r} + ["--result-file", {pred!r}]) == stats and len(stats) == 12
loaded = [name for name, m in list(sys.modules.items())
          if str(getattr(m, "__file__", None)).startswith(jax_root)]
assert not loaded and not touched, (loaded, touched[:5])
assert "jax" not in sys.modules, "jax was imported"
print("ok", len(tree))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("ok")

