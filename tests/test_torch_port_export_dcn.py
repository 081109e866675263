"""Export of a tiny R50-DCN model (DCNv2 in stages 2-4: ``deform_conv_unfused``
on the CPU's float32; the 16-bit stage-2 layers take ``deform_conv_fused``
on the card), checked as tests/test_torch_port_export_configs.py checks the
int8 model: traced at B=2 (one image padded), its encoder sampling
"float", equal to its live model at rtol 1e-3 / atol 1e-5 and to the JAX
package's live forward at rtol 1e-3 / atol 1e-3.  The program is not saved
here, for the lane's time (the int8 and flagship exports are saved and
loaded on the CPU, R50-DCN's on the card by ``chip_smoke.py``)."""

from tests.test_torch_port_export_configs import check_export
from tests.torch_port_common import two_torch_threads  # noqa: F401


def test_tiny_r50_dcn_model_exports_and_matches_live_and_jax(monkeypatch, tmp_path):
    check_export(monkeypatch, tmp_path, "r50_dcn", {"stage_with_dcn": (False, True, True, True)}, "none",
                 {"ms_deform_attn", "grid_nms_topk", "deform_conv_unfused"}, "float", saved=False)
