"""The kernels as registered operators and the port's export tool, on the
CPU: each operator's CPU result exactly equal to its plain function (and
its fake implementation's shapes; B6's and B8's FLOP formulas and B6's
autograd), the tiny model exported with
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
from torch.utils.flop_counter import FlopCounterMode

from salience_detr_tpu.data.loader import pack_batch as jax_pack_batch
from salience_detr_tpu.data.transforms import shortest_size as jax_shortest_size
from salience_detr_tpu.models.detectors.salience_detr import normalize_images as jax_normalize
from salience_detr_torch.ops import deform_attn, deform_conv, nms
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


def dcn_inputs(seed=3, B=2, H=7, W=9, C=32, F=16, stride=1):
    rng = np.random.default_rng(seed)
    Ho, Wo = deform_conv.output_size(H, stride), deform_conv.output_size(W, stride)
    x = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32))
    offsets = torch.from_numpy(rng.normal(0, 1.5, (B, Ho, Wo, 18)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(0, 1, (B, Ho, Wo, 9)).astype(np.float32))
    weight = torch.from_numpy((rng.normal(size=(9, C, F)) / 12).astype(np.float32))
    d_cols = torch.from_numpy(rng.normal(size=(B, Ho, Wo, 9, C)).astype(np.float32))
    return x, offsets, mask, weight, d_cols


def b6_b8_cases():
    """(op, its arguments, the plain function's result, FLOPs or None): B6's
    columns, gather backward (with and without d_x), fused and unfused layers
    at stride 1 and 2, B8's quantise and sample (float32 and float16)."""
    cases = {}
    for stride in (1, 2):
        x, off, msk, w, d_cols = dcn_inputs(stride=stride)
        B, Ho, Wo, _ = off.shape
        sample_flops = 2 * 4 * B * Ho * Wo * 9 * 32
        cases[f"deform_conv_columns s{stride}"] = (
            torch.ops.salience_detr.deform_conv_columns, (x, off, msk, stride),
            deform_conv.deform_conv_sample_plain(x, off, msk, stride), sample_flops)
        for need_x in (True, False):
            d_x, d_off, d_mask = deform_conv.deform_conv_sample_backward_plain(x, off, msk, stride, d_cols, need_x)
            cases[f"deform_conv_backward s{stride} need_x={need_x}"] = (
                torch.ops.salience_detr.deform_conv_backward, (x, off, msk, d_cols, stride, need_x),
                (d_x if need_x else x.new_empty(0), d_off, d_mask), 3 * sample_flops)
        layer = deform_conv.deform_conv2d_plain(x, off, msk, w, stride)
        for op in ("deform_conv_fused", "deform_conv_unfused"):
            cases[f"{op} s{stride}"] = (getattr(torch.ops.salience_detr, op), (x, off, msk, w, stride), layer,
                                        2 * B * Ho * Wo * 9 * 32 * 16 + sample_flops)
    value, locs, weights = msda_inputs(1, seed=4, C=32)
    locs = locs[:, :, 0].contiguous()  # head-shared (B, Q, L, P, 2)
    flat = [n for hw in LEVELS for n in hw]
    cases["q8_quantize"] = (torch.ops.salience_detr.q8_quantize, (value,), deform_attn.q8_quantize_plain(value),
                            None)
    table, scale = deform_attn.q8_quantize_plain(value)
    for dtype in (torch.float32, torch.float16):
        cases[f"q8_sample {dtype}"] = (
            torch.ops.salience_detr.q8_sample, (table, scale, locs, weights, flat, dtype),
            deform_attn.q8_sample_plain(table, scale, LEVELS, locs, weights, dtype), 2 * 4 * 2 * 5 * 32 * 3 * 2)
    return cases


B6_B8 = b6_b8_cases()


@pytest.mark.parametrize("case", sorted(B6_B8))
def test_b6_b8_operators_are_the_plain_versions_on_the_cpu(case):
    """Each B6 and B8 operator's CPU result equals its plain function bit for
    bit, its fake implementation gives the shapes and dtypes of that result,
    and the FLOP counter reads its formula."""
    op, args, want, flops = B6_B8[case]
    got = op(*args)
    want_tuple = want if isinstance(want, tuple) else (want,)
    got_tuple = got if isinstance(got, tuple) else (got,)
    assert len(got_tuple) == len(want_tuple)
    for g, w in zip(got_tuple, want_tuple):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    fake_tuple = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(f.shape), f.dtype) for f in fake_tuple] == [(tuple(w.shape), w.dtype) for w in want_tuple]
    if flops is not None:
        with FlopCounterMode(display=False) as counter:
            op(*args)
        assert counter.get_total_flops() == flops


def test_b6_layer_backward_is_the_recompute_on_the_operators():
    """``deform_conv2d``'s gradients through either route's operator equal
    the plain backward's (columns recomputed, the two products, the plain
    gather backward), and ``deform_conv_sample``'s those of the plain
    sampling backward; the route is fixed by dtype and F alone."""
    x, off, msk, w, d_cols = dcn_inputs()
    assert deform_conv.uses_fused_kernel(torch.bfloat16, 16) and not deform_conv.uses_fused_kernel(torch.float32, 16)
    grads = {}
    for op in ("deform_conv_fused", "deform_conv_unfused"):
        leaves = [a.clone().requires_grad_() for a in (x, off, msk, w)]
        out = getattr(torch.ops.salience_detr, op)(*leaves, 1)
        out.backward(torch.ones_like(out))
        grads[op] = [a.grad for a in leaves]
    cols = deform_conv.deform_conv_sample_plain(x, off, msk, 1)
    g = torch.ones(cols.shape[:3] + (16,)).reshape(-1, 16)
    want_w = (cols.reshape(-1, 9 * 32).t() @ g).reshape(w.shape)
    want_x, want_off, want_mask = deform_conv.deform_conv_sample_backward_plain(
        x, off, msk, 1, (g @ w.reshape(9 * 32, 16).t()).reshape(cols.shape))
    for got in grads.values():
        for a, b in zip(got, (want_x, want_off, want_mask, want_w)):
            assert torch.equal(a, b)
    leaves = [a.clone().requires_grad_() for a in (x, off, msk)]
    deform_conv.deform_conv_sample(*leaves, 1).backward(d_cols)
    for a, b in zip(leaves, deform_conv.deform_conv_sample_backward_plain(x, off, msk, 1, d_cols)):
        assert torch.equal(a.grad, b)


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
