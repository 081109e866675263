"""Export of the configs whose kernels joined the registered operators: the
tiny hybrid model with ``MSDA_GATHER_QUANT=int8`` at trace time
(``q8_quantize`` and ``q8_sample`` in the encoder) here, and a tiny R50-DCN
model in tests/test_torch_port_export_dcn.py (one file each, for the
lane's time), each traced by
``torch.export`` on the CPU at B=2 (one image padded), saved and loaded
with its encoder sampling recorded.  The loaded program equals its live
model at the export tool's rtol 1e-3 / atol 1e-5 and the JAX package's
live forward (the same switch set for the int8 model) at the full-model
tolerance, rtol 1e-3 / atol 1e-3, on the last decoder layer's logits and
boxes."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.tools import export as export_tool
from salience_detr_torch.weights import state_dict_from_jax
from tests.torch_port_common import (
    CANVAS,
    TINY_JAX,
    TINY_TORCH,
    jax_variable_shapes,
    random_variables,
    t,
    two_torch_threads,  # noqa: F401
)


def check_export(monkeypatch, tmp_path, case, fields, quant, ops, sampling, saved=True):
    """The tiny model of ``fields`` under ``MSDA_GATHER_QUANT=quant``:
    exported (with ``saved``, saved and loaded, recording ``sampling``), its
    graph calling ``ops``, held against the live model and the JAX
    forward."""
    monkeypatch.setenv("MSDA_GATHER_QUANT", quant)
    jmodel, *_ = build_jax(JaxConfig(**TINY_JAX, **fields))
    variables = random_variables(jax_variable_shapes(jmodel), seed=12)
    tcfg = SalienceDETRConfig(**TINY_TORCH, **fields)
    tmodel, post = build_salience_detr(tcfg, torch.device("cpu"))
    tmodel.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)

    B, (H, W) = 2, CANVAS
    rng = np.random.default_rng(13)
    images = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    sizes = np.asarray([[H, W], [70, 101]], np.int64)
    inputs = (t(images).permute(0, 3, 1, 2).contiguous(), t(sizes))

    loaded = export_tool.export_detector(tmodel, post, tcfg, B, H, W, with_postprocess=False)
    recorded = export_tool.encoder_sampling(loaded)
    if saved:
        export_tool.save_program(loaded, tmp_path / f"{case}.pt2")
        loaded, recorded = export_tool.load_program(tmp_path / f"{case}.pt2")
    assert recorded == sampling
    assert set(export_tool.kernel_ops(loaded)) == {f"salience_detr.{op}.default" for op in ops}
    live = export_tool.DetectorProgram(tmodel, post, tcfg, False).eval()
    export_tool.verify(loaded, live, inputs)
    with torch.no_grad():
        logits, boxes = loaded.module()(*inputs)

    want = jax.jit(lambda v, x, s: jmodel.apply(v, x, s, train=False))(
        variables, jnp.asarray(images), jnp.asarray(sizes, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want["pred_class"][-1]), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want["pred_coord"][-1]), rtol=1e-3, atol=1e-3)


def test_tiny_int8_model_exports_and_matches_live_and_jax(monkeypatch, tmp_path):
    check_export(monkeypatch, tmp_path, "int8", {}, "int8",
                 {"ms_deform_attn", "grid_nms_topk", "q8_quantize", "q8_sample"}, "int8")
