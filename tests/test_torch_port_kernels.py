"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need a CUDA device (and nvcc, to build the kernels) and
skip without one; run them on a GPU machine with
``python -m pytest tests/test_torch_port_kernels.py -q``.  The rest check,
on any machine, the host-side pieces the kernels rely on.
"""

import pytest
import torch

from salience_detr_torch import native
from salience_detr_torch.ops.deform_attn import (
    ms_deform_attn,
    ms_deform_attn_backward_plain,
    ms_deform_attn_plain,
)
from salience_detr_torch.ops import msda_stages as st
from salience_detr_torch.ops.hungarian import batched_assignment, batched_assignment_plain
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
    assert {p.name for p in native.CSRC_DIR.glob("*.cu")} == {
        "msda.cu", "msda_backward.cu", "grid_nms.cu", "hungarian.cu",
        "gather_sum.cu", "weighted_reduce.cu", "corner_collapse.cu",
    }
    assert set(native.LAUNCHES) == {
        "msda", "msda_backward", "grid_nms", "hungarian",
        "gather_sum", "weighted_reduce", "corner_collapse_blocked", "corner_collapse_packed",
    }


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 4e-3, 1e-2)])
@pytest.mark.parametrize("G,H,C", [(1, 8, 256), (8, 8, 256), (2, 8, 256), (1, 4, 32), (4, 4, 32), (2, 8, 64)])
def test_msda_backward_kernel_matches_plain(cuda, dtype, atol, rtol, G, H, C):
    """d_value sums by f32 atomics in no fixed order, hence atol/rtol 1e-4 in
    float32; in bfloat16 both sides round one f32 sum to bf16 (one ulp)."""
    value, locs, w = msda_inputs(cuda, dtype, G=G, H=H, C=C, seed=1)
    d_out = torch.randn(value.shape[0], locs.shape[1], C, device=cuda).to(dtype)
    inputs = [x.clone().requires_grad_() for x in (value, locs, w)]
    before = native.LAUNCHES["msda_backward"]
    ms_deform_attn(*inputs[:1], LEVELS, *inputs[1:]).backward(d_out)
    torch.cuda.synchronize()
    assert native.LAUNCHES["msda_backward"] == before + 1
    want = ms_deform_attn_backward_plain(value, LEVELS, locs, w, d_out)
    for name, x, ref in zip(("d_value", "d_locations", "d_weights"), inputs, want):
        assert x.grad.dtype == ref.dtype, name
        torch.testing.assert_close(x.grad.float(), ref.float(), rtol=rtol, atol=atol, msg=name)


@pytest.mark.gpu
def test_msda_gradient_reaches_the_value_on_cuda(cuda):
    """The forward kernel's output carries a grad_fn: a loss on it reaches
    the value, the locations and the weights."""
    value, locs, w = msda_inputs(cuda, torch.float32)
    inputs = [x.clone().requires_grad_() for x in (value, locs, w)]
    out = ms_deform_attn(inputs[0], LEVELS, inputs[1], inputs[2])
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(x.grad is not None and bool(x.grad.abs().sum() > 0) for x in inputs)


@pytest.mark.gpu
def test_hungarian_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(2)
    cost = (torch.rand(4, 120, 25, generator=g) * 40 - 10).to(cuda)
    valid = torch.arange(25)[None] < torch.tensor([[25], [7], [0], [1]])
    valid = valid.to(cuda)
    before = native.LAUNCHES["hungarian"]
    got = batched_assignment(cost, valid)
    torch.cuda.synchronize()
    assert native.LAUNCHES["hungarian"] == before + 1
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, batched_assignment_plain(cost, valid), rtol=0, atol=0)
    with pytest.raises(ValueError):
        batched_assignment(cost[:, :20], valid)  # more gts than queries


@pytest.mark.gpu
def test_hungarian_kernel_stops_on_nan_costs(cuda):
    """A diverged model's NaN or inf costs end that image's search with -1
    for every gt (and the kernel ends); the other images are solved as
    usual."""
    g = torch.Generator().manual_seed(3)
    cost = torch.rand(4, 50, 10, generator=g).to(cuda)
    cost[1] = float("nan")
    cost[3, :, 4] = float("inf")
    valid = torch.ones(4, 10, dtype=torch.bool, device=cuda)
    got = batched_assignment(cost, valid)
    torch.cuda.synchronize()
    assert bool((got[1] == -1).all()) and bool((got[3] == -1).all())
    keep = torch.tensor([0, 2], device=cuda)
    torch.testing.assert_close(got[keep], batched_assignment_plain(cost[keep], valid[keep]), rtol=0, atol=0)


# the MSDA stage kernels K5-K8: f32 outputs within (atol 1e-5, rtol 1e-4),
# f32 sums in another order; bf16 outputs within one bf16 ulp (both sides
# round one f32 value)
STAGE_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (4e-3, 1e-2)}


def stage_close(got, want, dtype):
    atol, rtol = STAGE_TOL[dtype]
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def counted(name, fn, *args):
    before = native.LAUNCHES[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("G", [70, 5])
def test_gather_sum_kernel_matches_plain(cuda, G):
    """Q=37 queries of G rows each (70: two index windows, the second
    ragged); a few indices outside [0, S) are skipped on the card, so the
    plain version gets them as index 0 over a zero row 0."""
    g = torch.Generator().manual_seed(10)
    value = torch.randn(2, S, 4, 32, generator=g)
    value[:, 0] = 0
    idx = torch.randint(0, S, (2, 4, 37, G), generator=g, dtype=torch.int32)
    bad = idx.clone()
    bad[0, 0, 0, :3] = torch.tensor([-1, S, 1 << 30], dtype=torch.int32)
    value = value.to(cuda, torch.bfloat16)
    got = counted("gather_sum", st.gather_sum, value, bad.to(cuda))
    idx[0, 0, 0, :3] = 0
    stage_close(got, st.gather_sum_plain(value, idx.to(cuda)), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("K,H", [(4, 8), (2, 32), (1, 1)])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_weighted_reduce_kernel_matches_plain(cuda, K, H, wdtype):
    """N=45 rows (no multiple of any tile), I=5 items; C=256, and 512 for
    K=1 (two channel chunks per lane)."""
    g = torch.Generator().manual_seed(11)
    C = 512 if K == 1 else 256
    rows = torch.randn(45, 5, K * C, generator=g).to(cuda, torch.bfloat16)
    wt = torch.rand(45, 5 * K, H, generator=g)  # each head's weights sum to 1
    wt = (wt / wt.sum(1, keepdim=True)).reshape(45, 5, K * H).to(cuda, wdtype)
    got = counted("weighted_reduce", st.weighted_reduce, rows, wt, K)
    stage_close(got, st.weighted_reduce_plain(rows, wt, K), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_corner_collapse_kernels_match_plain(cuda, out_dtype, wdtype):
    """K7 on 3 groups of blk=16 with 37 items (the last group ragged) and K8
    on 37 packed items; C=256 and 512."""
    g = torch.Generator().manual_seed(12)
    for C in (256, 512):
        blocked = torch.randn(3, 64, C, generator=g).to(cuda, torch.bfloat16)
        bw = torch.rand(3, 64, generator=g).to(cuda, wdtype)
        got = counted("corner_collapse_blocked", st.corner_collapse_blocked, blocked, bw, 37, out_dtype)
        assert tuple(got.shape) == (37, C)
        stage_close(got, st.corner_collapse_blocked_plain(blocked, bw, 37, out_dtype), out_dtype)
        packed = torch.randn(37, 4 * C, generator=g).to(cuda, torch.bfloat16)
        pw = torch.rand(37, 4, generator=g).to(cuda, wdtype)
        got = counted("corner_collapse_packed", st.corner_collapse_packed, packed, pw, out_dtype)
        stage_close(got, st.corner_collapse_packed_plain(packed, pw, out_dtype), out_dtype)


@pytest.mark.gpu
def test_stage_kernels_reject_what_they_cannot_take(cuda):
    rows = torch.randn(6, 4, 4 * 256, device=cuda).to(torch.bfloat16)
    wt = torch.rand(6, 4, 4 * 8, device=cuda)
    with pytest.raises(TypeError):
        st.weighted_reduce(rows.float(), wt, 4)
    with pytest.raises(TypeError):
        st.weighted_reduce(rows, wt.double(), 4)
    with pytest.raises(ValueError):
        st.weighted_reduce(rows.transpose(0, 1), wt.transpose(0, 1), 4)  # not contiguous
    with pytest.raises(ValueError):
        st.weighted_reduce(rows, wt, 3)
    packed, pw = rows.reshape(24, 1024), torch.rand(24, 4, device=cuda)
    with pytest.raises(ValueError):
        st.corner_collapse_packed(packed[:, :512], pw, torch.float32)  # not contiguous, C=128
    with pytest.raises(TypeError):
        st.corner_collapse_packed(packed, pw, torch.float16)
    with pytest.raises(ValueError):
        st.corner_collapse_blocked(packed.reshape(6, 16, 256), pw.reshape(6, 16), 25, torch.float32)
    value = torch.randn(2, S, 4, 32, device=cuda).to(torch.bfloat16)
    idx = torch.randint(0, S, (2, 4, 5, 7), device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        st.gather_sum(value, idx.long())
    with pytest.raises(ValueError):
        st.gather_sum(value[..., :24].contiguous(), idx)  # D=24
