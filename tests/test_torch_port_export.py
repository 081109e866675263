"""The kernels as registered operators and the port's export tool, on the
CPU: each operator's CPU result exactly equal to its plain function (and
its fake implementation's shapes), the tiny model exported with
``--with-postprocess`` (B=1, 96x128), saved and loaded, against the live
module at rtol 1e-3 / atol 1e-5, the graph calling the MSDA and grid-NMS
operators, and ``ExportedDetector`` against the JAX package's live pipeline
(shortest-size resize, canvas, forward, PostProcess, score filter) on an
image that is not the canvas's size: boxes and scores at rtol 1e-3 / atol
1e-3 (the full-model tolerance), labels and kept indices exact."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from salience_detr_tpu.data.loader import pack_batch as jax_pack_batch
from salience_detr_tpu.data.transforms import shortest_size as jax_shortest_size
from salience_detr_tpu.models.detectors.salience_detr import normalize_images as jax_normalize
from salience_detr_torch.ops import deform_attn, nms
from salience_detr_torch.tools import export as export_tool
from salience_detr_torch.weights import state_dict_from_jax
from tests.torch_port_common import (
    TINY_TORCH,
    build_jax_tiny,
    jax_variable_shapes,
    random_variables,
    two_torch_threads,  # noqa: F401
)

LEVELS = [(6, 8), (3, 4), (2, 2)]
KERNEL_OPS = {"salience_detr.ms_deform_attn.default", "salience_detr.grid_nms_topk.default"}


def msda_inputs(G, seed=0, B=2, Q=5, H=4, C=32, P=2):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in LEVELS)
    value = torch.from_numpy(rng.normal(size=(B, S, C)).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, Q, G, len(LEVELS), P, 2)).astype(np.float32))
    weights = torch.from_numpy(rng.uniform(0, 1, (B, Q, H, len(LEVELS), P)).astype(np.float32))
    return value, locs, weights


@pytest.mark.parametrize("G", [1, 2, 4])
def test_msda_operator_is_the_plain_version_on_the_cpu(G):
    value, locs, weights = msda_inputs(G)
    flat = [n for hw in LEVELS for n in hw]
    got = torch.ops.salience_detr.ms_deform_attn(value, locs, weights, flat)
    assert torch.equal(got, deform_attn.ms_deform_attn_plain(value, LEVELS, locs, weights))
    with FakeTensorMode() as mode:
        fake = torch.ops.salience_detr.ms_deform_attn(*(mode.from_tensor(t) for t in (value, locs, weights)), flat)
    assert tuple(fake.shape) == tuple(got.shape) and fake.dtype == got.dtype
    assert deform_attn.ms_deform_attn_flops(value.shape, locs.shape, weights.shape, flat) == 2 * 4 * 2 * 5 * 32 * 3 * 2


def test_grid_nms_operator_is_the_plain_version_on_the_cpu():
    S = sum(h * w for h, w in LEVELS)
    rng = np.random.default_rng(1)
    index = torch.from_numpy(np.stack([rng.permutation(S)[:40] for _ in range(3)]).astype(np.int32))
    got = torch.ops.salience_detr.grid_nms_topk(index, [n for hw in LEVELS for n in hw], 12)
    assert torch.equal(got, nms.grid_nms_topk_plain(index, LEVELS, 12))
    with FakeTensorMode() as mode:
        fake = torch.ops.salience_detr.grid_nms_topk(mode.from_tensor(index), [6, 8, 3, 4, 2, 2], 12)
    assert tuple(fake.shape) == (3, 12) and fake.dtype == torch.int32


def test_nms_keep_operator_is_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 50, (2, 30, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 30, (2, 30, 2))], -1).astype(np.float32))
    got = torch.ops.salience_detr.nms_keep_mask(boxes, 0.5)
    assert torch.equal(got, nms.nms_keep_mask_plain(boxes, 0.5))
    assert 0 < int(got.sum()) < got.numel()
    with FakeTensorMode() as mode:
        fake = torch.ops.salience_detr.nms_keep_mask(mode.from_tensor(boxes), 0.5)
    assert tuple(fake.shape) == (2, 30) and fake.dtype == torch.bool


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """The tiny hybrid model's JAX variables, the same weights as the port's
    state dict in a file, and that file exported with --with-postprocess
    (what the CLI printed)."""
    jcfg, tcfg, jmodel = build_jax_tiny()
    variables = random_variables(jax_variable_shapes(jmodel), seed=4)
    root = tmp_path_factory.mktemp("export")
    torch.save(state_dict_from_jax(variables, tcfg), root / "tiny.pth")
    cfg = root / "tiny_config.py"
    cfg.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                   f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        export_tool.main(["--model-config", str(cfg), "--checkpoint", str(root / "tiny.pth"), "--height", "96",
                          "--width", "128", "--batch", "1", "--output", str(root / "tiny_post.pt2"),
                          "--with-postprocess", "--device", "cpu"])
    return jcfg, tcfg, jmodel, variables, root, cfg, printed.getvalue()


def test_exported_program_matches_the_live_model_and_calls_the_kernel_operators(bridged):
    *_, root, cfg, printed = bridged
    out = root / "tiny_post.pt2"
    assert "restored checkpoint" in printed and "verification passed (rtol=0.001, atol=1e-05)" in printed
    program = torch.export.load(str(out))
    assert KERNEL_OPS <= set(export_tool.call_targets(program))
    # the check itself: seeded pixels of another seed through the loaded
    # program and the live module
    from salience_detr_torch.inference import Predictor
    from salience_detr_torch.models.factory import SalienceDETRConfig
    from salience_detr_torch.test import load_state_dict

    tcfg = SalienceDETRConfig(**TINY_TORCH)
    served = Predictor(tcfg, load_state_dict(str(root / "tiny.pth")), "cpu")
    live = export_tool.DetectorProgram(served.model, served.postprocess, tcfg, True)
    inputs = export_tool.example_inputs(1, 96, 128, True, torch.device("cpu"), seed=7)
    gaps = export_tool.verify(program, live, inputs)
    assert sorted(gaps) == ["boxes", "labels", "scores", "valid"]
    shifted = lambda *a: {k: v + 1e-2 if k == "scores" else v for k, v in live(*a).items()}  # noqa: E731
    with pytest.raises(AssertionError, match="differs"):
        export_tool.verify(program, shifted, inputs)


def test_program_without_postprocess_is_refused_by_the_runner(bridged):
    *_, root, cfg, _ = bridged
    out = root / "tiny_logits.pt2"
    export_tool.main(["--model-config", str(cfg), "--height", "96", "--width", "128", "--output", str(out),
                      "--device", "cpu", "--no-verify"])
    program = torch.export.load(str(out))
    assert KERNEL_OPS <= set(export_tool.kernel_ops(program))
    with pytest.raises(ValueError, match="--with-postprocess"):
        export_tool.ExportedDetector(program)


def test_exported_detector_matches_the_jax_live_pipeline(bridged):
    jcfg, tcfg, jmodel, variables, root, *_ = bridged
    from salience_detr_tpu.models.factory import build_salience_detr as build_jax

    *_, jpost = build_jax(jcfg)
    image = np.random.default_rng(11).integers(0, 255, (73, 111, 3), dtype=np.uint8)
    sample = jax_shortest_size({"image": image, "boxes": np.zeros((0, 4), np.float32),
                                "labels": np.zeros((0,), np.int64), "orig_size": image.shape[:2]},
                               jcfg.min_size, jcfg.max_size)
    batch = jax_pack_batch([sample], (96, 128), max_gt=1)
    out = jax.jit(lambda v, x, s: jmodel.apply(v, x, s, train=False))(
        variables, jax_normalize(jnp.asarray(batch["images"], jnp.float32) / 255.0), jnp.asarray(batch["image_sizes"]))
    want = jax.device_get(jpost(out["pred_class"][-1], out["pred_coord"][-1], jnp.asarray(batch["orig_sizes"])))
    # the score threshold halfway between the 10th and 11th of the top 20
    ranked = np.sort(want["scores"][0])[::-1]
    threshold = float(ranked[9] + ranked[10]) / 2
    keep_want = np.flatnonzero(want["valid"][0].astype(bool) & (want["scores"][0] > threshold))

    det = export_tool.ExportedDetector(str(root / "tiny_post.pt2"), min_size=tcfg.min_size, max_size=tcfg.max_size,
                                       score_threshold=threshold)
    assert det.batch == 1 and det.canvas == (96, 128)
    raw = det.detect([image])
    got = det(image)
    keep_got = np.flatnonzero(raw["valid"][0] & (raw["scores"][0] > threshold))
    np.testing.assert_array_equal(keep_got, keep_want)
    assert len(keep_got) == 10
    np.testing.assert_array_equal(got["labels"], want["labels"][0][keep_want])
    np.testing.assert_allclose(got["scores"], want["scores"][0][keep_want], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["boxes"], want["boxes"][0][keep_want], rtol=1e-3, atol=1e-3)
