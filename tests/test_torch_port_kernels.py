"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need a CUDA device (and nvcc, to build the kernels) and
skip without one; run them on a GPU machine with
``python -m pytest tests/test_torch_port_kernels.py -q``.  The rest check,
on any machine, the host-side pieces the kernels rely on.
"""

import pytest
import torch

from salience_detr_torch import native
from salience_detr_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_plain
from salience_detr_torch.ops.nms import grid_nms_topk, grid_nms_topk_plain

LEVELS = [(10, 14), (5, 7), (3, 4), (1, 2)]
S = sum(h * w for h, w in LEVELS)


def test_level_table_layout():
    table = native.level_table(LEVELS)
    assert table.num_levels == 4
    assert list(table.h)[:4] == [10, 5, 3, 1] and list(table.w)[:4] == [14, 7, 4, 2]
    assert list(table.start)[:4] == [0, 140, 175, 187]
    with pytest.raises(ValueError):
        native.level_table([(1, 1)] * (native.MAX_LEVELS + 1))


def test_library_path_tracks_the_sources():
    path = native.library_path()
    assert path.name == "libkernels.so" and path.parent.name == native.source_hash()
    assert path.parent.parent == native.BUILD_ROOT
    assert {p.name for p in native.CSRC_DIR.glob("*.cu")} == {"msda.cu", "grid_nms.cu"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def msda_inputs(device, dtype, B=2, Q=33, G=1, H=8, C=256, P=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    value = torch.randn(B, S, C, generator=g).to(device, dtype)
    locs = (torch.rand(B, Q, G, len(LEVELS), P, 2, generator=g) * 1.6 - 0.3).to(device)
    w = torch.rand(B, Q, H, len(LEVELS), P, generator=g).to(device)
    return value, locs, w / w.sum((-2, -1), keepdim=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-4), (torch.bfloat16, 4e-3, 1e-2)])
@pytest.mark.parametrize("G,H,C", [(1, 8, 256), (8, 8, 256), (2, 8, 256), (1, 4, 32), (4, 4, 32), (2, 8, 64)])
def test_msda_kernel_matches_plain(cuda, dtype, atol, rtol, G, H, C):
    value, locs, w = msda_inputs(cuda, dtype, G=G, H=H, C=C)
    before = native.LAUNCHES["msda"]
    got = ms_deform_attn(value, LEVELS, locs, w)
    torch.cuda.synchronize()
    assert native.LAUNCHES["msda"] == before + 1
    want = ms_deform_attn_plain(value, LEVELS, locs, w)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_msda_kernel_rejects_what_it_cannot_take(cuda):
    value, locs, w = msda_inputs(cuda, torch.float32)
    with pytest.raises(TypeError):
        ms_deform_attn(value.half(), LEVELS, locs, w)
    with pytest.raises(ValueError):
        ms_deform_attn(value[:, :, :96].contiguous(), LEVELS, locs, w[:, :, :3])  # C=96
    with pytest.raises(ValueError):
        ms_deform_attn(value[:, :, :128].contiguous(), LEVELS, locs, w)  # C=128: no kernel
    with pytest.raises(ValueError):
        ms_deform_attn(value.transpose(0, 1).contiguous().transpose(0, 1), LEVELS, locs, w)
    with pytest.raises(ValueError):
        ms_deform_attn(value, LEVELS[:3], locs, w)


@pytest.mark.gpu
def test_grid_nms_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(0)
    topk = torch.stack([torch.randperm(S, generator=g)[:120] for _ in range(3)])
    topk[1] = torch.arange(120)  # a dense raster clump: long suppression chains
    topk = topk.to(cuda, torch.int32).contiguous()
    before = native.LAUNCHES["grid_nms"]
    got = grid_nms_topk(topk, LEVELS, 60)
    torch.cuda.synchronize()
    assert native.LAUNCHES["grid_nms"] == before + 1
    torch.testing.assert_close(got, grid_nms_topk_plain(topk, LEVELS, 60), rtol=0, atol=0)
    with pytest.raises(TypeError):
        grid_nms_topk(topk.long(), LEVELS, 60)
    with pytest.raises(ValueError):
        grid_nms_topk(topk, LEVELS, 121)
