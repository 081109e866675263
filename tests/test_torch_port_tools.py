"""The port's user tools against the JAX package's, on the CPU:
benchmark_model's parameter count equal to the JAX tool's (its eval init's
``params``), its FLOP count holding the MSDA operator's formula over the
layers' shapes, the salience maps of ``tools.feature_viz`` against the JAX
model's ``out["salience"]`` (rtol 1e-3 / atol 1e-3, the full-model
tolerance), the port's notebooks (valid, parseable, calling only what
exists, reproduced by their generator), and the new tools run in a process
that never imports JAX."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_torch.models.factory import build_salience_detr
from salience_detr_torch.tools import benchmark_model, feature_viz, make_notebooks
from salience_detr_torch.weights import state_dict_from_jax
from tests.torch_port_common import (
    CANVAS,
    TINY_TORCH,
    build_jax_tiny,
    jax_variable_shapes,
    random_variables,
    t,
    two_torch_threads,  # noqa: F401
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg, jmodel = build_jax_tiny()
    variables = random_variables(jax_variable_shapes(jmodel), seed=5)
    model, _ = build_salience_detr(tcfg, torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
    return jcfg, tcfg, jmodel, variables, model.eval()


def test_parameter_count_equals_the_jax_tools(tiny):
    """The JAX tool counts the leaves of its eval init's ``params``
    collection (eval_shape here: nothing is computed)."""
    jcfg, tcfg, jmodel, _, model = tiny
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *CANVAS, 3)),
                                                jnp.full((1, 2), 32, jnp.int32), train=False))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    assert benchmark_model.count_parameters(model) == want
    assert want < sum(p.numel() for p in model.parameters())  # the train-only denoising table is left out


def msda_queries(cfg, canvas=CANVAS):
    """The queries of each MSDA call of an eval forward, from the config:
    encoder layer i samples the first layer_filter_ratio[i] of the
    level-budgeted tokens, each decoder layer the two-stage proposals."""
    H, W = canvas
    shapes = [(-(-H // s), -(-W // s)) for s in (8, 16, 32)]
    shapes.append((-(-shapes[-1][0] // 2), -(-shapes[-1][1] // 2)))
    sizes = [h * w for h, w in shapes]
    K = sum(max(int(n * r), 1) for n, r in zip(sizes, cfg.level_filter_ratio))
    encoder = [max(int(K * r), 1) for r in cfg.layer_filter_ratio]
    proposals = min(cfg.num_queries, min(4 * cfg.num_queries, sum(sizes)))
    return encoder + [proposals] * cfg.num_decoder_layers


def test_flop_count_holds_the_msda_formula(tiny):
    _, tcfg, _, _, model = tiny
    images = torch.randn(2, 3, *CANVAS, generator=torch.Generator().manual_seed(0))
    sizes = torch.tensor([list(CANVAS), [70, 101]])
    flops = benchmark_model.forward_flops(model, images, sizes, torch.no_grad())
    # 4 corners x D channels a (b, q, h, l, p), a multiply and an add each
    want = sum(2 * 4 * 2 * q * tcfg.embed_dim * tcfg.num_feature_levels * tcfg.num_points for q in msda_queries(tcfg))
    assert flops["ms_deform_attn"] == want
    assert flops["convolution"] > 0 and flops["matmul"] > 0
    assert flops["total"] == sum(v for k, v in flops.items() if k != "total")
    assert all(p.requires_grad for p in model.transformer.parameters())  # restored after the count


def test_salience_maps_match_jax(tiny):
    _, tcfg, jmodel, variables, model = tiny
    rng = np.random.default_rng(6)
    images = rng.normal(size=(2, *CANVAS, 3)).astype(np.float32)
    sizes = np.asarray([list(CANVAS), [70, 101]], np.int32)
    want = jax.jit(lambda v, x, s: jmodel.apply(v, x, s, train=False))(variables, jnp.asarray(images),
                                                                        jnp.asarray(sizes))["salience"]
    got = feature_viz.salience_maps(model, tcfg, t(images).permute(0, 3, 1, 2).contiguous(), t(sizes).long())
    assert len(got) == len(want) == 4
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[..., 0], rtol=1e-3, atol=1e-3, err_msg=f"level {lvl}")
    heat = feature_viz.colorize(got[0][0].numpy())
    assert heat.shape == (*got[0].shape[1:], 3) and heat.dtype == np.uint8


NOTEBOOKS = sorted(make_notebooks.NOTEBOOKS)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_is_valid_and_its_cells_parse(name):
    nb = json.loads((make_notebooks.OUT_DIR / name).read_text())
    assert nb["nbformat"] == 4
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert code, name
    for i, cell in enumerate(code):
        ast.parse("".join(cell["source"]), filename=f"{name}:cell{i}")


def test_notebooks_call_only_the_ports_api():
    """Every name a notebook imports from the port exists, and none imports
    JAX or the JAX package."""
    import importlib

    seen = set()
    for notebook in make_notebooks.NOTEBOOKS.values():
        for cell in notebook["cells"]:
            if cell["cell_type"] != "code":
                continue
            for node in ast.walk(ast.parse("".join(cell["source"]))):
                if isinstance(node, ast.ImportFrom):
                    assert not node.module.startswith(("jax", "salience_detr_tpu", "tools")), node.module
                    if node.module.startswith("salience_detr_torch"):
                        module = importlib.import_module(node.module)
                        for alias in node.names:
                            assert hasattr(module, alias.name), (node.module, alias.name)
                            seen.add(f"{node.module}.{alias.name}")
                elif isinstance(node, ast.Import):
                    assert not any(a.name.startswith(("jax", "salience_detr_tpu")) for a in node.names)
    assert "salience_detr_torch.tools.grad_cam.make_cam_fn" in seen
    assert "salience_detr_torch.tools.feature_viz.salience_maps" in seen


def test_notebooks_are_what_the_generator_writes():
    """make_notebooks reproduces the committed files (edit the generator,
    not the JSON)."""
    for name, built in make_notebooks.NOTEBOOKS.items():
        assert json.loads((make_notebooks.OUT_DIR / name).read_text()) == built, name


def test_tools_run_without_jax(tmp_path):
    """The new modules imported in a fresh process and the tools' functions
    run on the tiny model (parameters and FLOPs, an export with its check,
    the salience maps, a Grad-CAM, a folder through InferenceDataset), the
    twins of the last root tools imported and the campaign report run, with
    neither JAX nor the JAX package imported."""
    np.save(tmp_path / "x.npy", np.random.default_rng(0).integers(0, 256, (70, 90, 3), dtype=np.uint8))
    script = f"""
import sys
import torch
from salience_detr_torch.models.factory import SalienceDETRConfig
from salience_detr_torch.tools import benchmark_model, export, feature_viz, grad_cam, make_notebooks
from salience_detr_torch.tools import visualize_datasets
from salience_detr_torch.tools import backbone_bench, bench_loader, parity_runbook, profile_trace
from salience_detr_torch.tools import quality_campaign_report, trace_report
from salience_detr_torch.inference import Predictor
from salience_detr_torch.tools.common import folder_batches
from salience_detr_torch.utils import visualize
cfg = SalienceDETRConfig(**{TINY_TORCH!r})
served = Predictor(cfg, None, "cpu")
model, post = served.model, served.postprocess
(path, batch), = folder_batches({str(tmp_path)!r}, cfg, "cpu")
r = benchmark_model.benchmark(model, cfg, 1, 96, 128, repeats=1)
assert r["params"] > 0 and r["flops"]["ms_deform_attn"] > 0 and r["peak_bytes"] is None
program = export.export_detector(model, post, cfg, 1, 96, 128, True)
export.verify(program, export.DetectorProgram(model, post, cfg, True),
              export.example_inputs(1, 96, 128, True, torch.device("cpu")))
maps = feature_viz.salience_maps(model, cfg, batch["images"], batch["image_sizes"])
cam, logits, coords = grad_cam.make_cam_fn(model, 1, 5, cfg)(batch["images"], batch["image_sizes"])
assert len(maps) == 4 and bool(torch.isfinite(cam).all())
assert quality_campaign_report.report(str(quality_campaign_report.RECORDS))[0].endswith("seeds [0]")
assert trace_report.category("void at::vectorized_elementwise_kernel<4>") == "elementwise_reduce"
assert "jax" not in sys.modules and "salience_detr_tpu" not in sys.modules, sorted(sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
