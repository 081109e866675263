"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need a CUDA device (and nvcc, to build the kernels) and
skip without one; run them on a GPU machine with
``python -m pytest tests/test_torch_port_kernels.py -q``.  The rest check,
on any machine, the host-side pieces the kernels rely on.
"""

import numpy as np
import pytest
import torch

from salience_detr_torch import native
from salience_detr_torch.ops.deform_attn import (
    _backward_cuda_ordered,
    backward_design,
    ms_deform_attn,
    ms_deform_attn_backward_plain,
    ms_deform_attn_plain,
)
from salience_detr_torch.ops import msda_stages as st
from salience_detr_torch.ops.hungarian import (
    batched_assignment,
    batched_assignment_plain,
    batched_mixed_assignment,
    batched_mixed_assignment_plain,
)
from salience_detr_torch.ops.nms import (
    SMEM_OPTIN_BYTES,
    grid_nms_rank_in_global,
    grid_nms_topk,
    grid_nms_topk_plain,
    nms_keep_mask,
    nms_keep_mask_cuda,
    nms_keep_mask_plain,
    nms_keep_plan,
    nms_keep_smem_bytes,
)
from salience_detr_torch.tools import gather_cluster

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
        "msda.cu", "msda_backward.cu", "grid_nms.cu", "hungarian.cu", "nms_keep.cu",
        "gather_sum.cu", "weighted_reduce.cu", "corner_collapse.cu", "deform_conv.cu", "deform_conv_gemm.cu",
        "msda_q8.cu",
    }
    assert set(native.LAUNCHES) == {
        "msda", "msda_backward", "msda_backward_ordered", "grid_nms", "hungarian", "nms_keep",
        "gather_sum", "weighted_reduce", "corner_collapse_blocked", "corner_collapse_packed",
        "deform_conv", "deform_conv_backward", "deform_conv_fused", "msda_q8_quantize", "msda_q8_sample",
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
    """float64 and malformed inputs raise; a float16 value (fp16 autocast)
    is sampled in float32 and comes back float16."""
    value, locs, w = msda_inputs(cuda, torch.float32)
    with pytest.raises(TypeError):
        ms_deform_attn(value.double(), LEVELS, locs, w)
    half = ms_deform_attn(value.half(), LEVELS, locs, w)
    assert half.dtype == torch.float16
    torch.testing.assert_close(half.float(), ms_deform_attn_plain(value.half().float(), LEVELS, locs, w),
                               rtol=1e-3, atol=1e-3)
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


def random_boxes(rng, B, N, extent=100.0, size=(5.0, 40.0)):
    """(B, N, 4) float32 xyxy boxes with corners in [0, extent + size]."""
    xy = rng.uniform(0, extent, (B, N, 2))
    wh = rng.uniform(*size, (B, N, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def chain_boxes(N=300):
    """Boxes 10 wide at steps of 2.5: a box overlaps its neighbours at IoU 0.6
    and the next ones at 1/3, so at threshold 0.5 each decision waits for the
    previous one (the JAX fixpoint's depth is N)."""
    x = np.arange(N, dtype=np.float32) * 2.5
    return np.stack([x, np.zeros(N, np.float32), x + 10, np.full(N, 10, np.float32)], -1)[None]


def tie_boxes(rng, N=200):
    """Boxes with integer corners in [0, 8]: their IoUs are small-integer
    ratios computed exactly, many of them exactly 1/2."""
    lo = rng.integers(0, 7, (1, N, 2))
    hi = lo + rng.integers(1, 3, (1, N, 2))
    return np.concatenate([lo, hi], -1).astype(np.float32)


def nms_keep_cases():
    """name -> ((B, N, 4) float32 boxes in rank order, IoU threshold): random
    boxes at three thresholds, the chain, all boxes identical, IoUs exactly
    at the threshold, one box."""
    rng = np.random.default_rng(0)
    out = {f"random_{thr}": (random_boxes(rng, 2, 300), thr) for thr in (0.3, 0.5, 0.7)}
    out["chain"] = (chain_boxes(), 0.5)
    out["identical"] = (np.tile(np.float32([[[3.0, 4.0, 50.0, 60.0]]]), (2, 300, 1)), 0.7)
    out["ties"] = (tie_boxes(rng), 0.5)
    out["one_box"] = (random_boxes(rng, 2, 1), 0.5)
    return out


NMS_KEEP_CASES = nms_keep_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(NMS_KEEP_CASES) + ["max_boxes", "max_boxes_clustered", "global_2048",
                                                            "global_2048_clustered"])
def test_nms_keep_kernel_bit_exact(cuda, name):
    """Bit-exact against the plain fixpoint (run on the CPU), also at 1024
    boxes (the conflict rows in the walking block's shared memory) and at
    2048 (in the filling blocks'), spread out and crowded."""
    if name.startswith(("max_boxes", "global_2048")):
        rng = np.random.default_rng(1)
        extent = 60.0 if name.endswith("clustered") else 400.0
        n = 1024 if name.startswith("max_boxes") else 2048
        boxes, thr = random_boxes(rng, 3, n, extent * n / 1024), 0.5
    else:
        boxes, thr = NMS_KEEP_CASES[name]
    before = native.LAUNCHES["nms_keep"]
    got = nms_keep_mask(torch.from_numpy(boxes).to(cuda), thr)
    torch.cuda.synchronize()
    assert native.LAUNCHES["nms_keep"] == before + 1
    assert got.dtype == torch.bool and got.shape == boxes.shape[:2]
    want = nms_keep_mask_plain(torch.from_numpy(boxes), thr)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.gpu
def test_nms_keep_kernel_rejects_what_it_cannot_take(cuda):
    """Wrong dtypes and layouts raise; a count past 1024 boxes does not."""
    boxes = torch.from_numpy(random_boxes(np.random.default_rng(2), 1, 1025)).to(cuda)
    torch.testing.assert_close(nms_keep_mask(boxes, 0.5).cpu(), nms_keep_mask_plain(boxes.cpu(), 0.5), rtol=0, atol=0)
    with pytest.raises(TypeError):
        nms_keep_mask(boxes[:, :8].double(), 0.5)
    with pytest.raises(TypeError):
        nms_keep_mask(boxes[:, :16:2], 0.5)
    assert nms_keep_mask(boxes[:, :0].contiguous(), 0.5).shape == (1, 0)


def keep_boxes(rng, B, N, kind):
    """(B, N, 4) float32 boxes: spread out, crowded, all identical, or
    crowded with a twentieth of the boxes and some coordinates NaN."""
    if kind == "identical":
        return np.tile(np.float32([[[3.0, 4.0, 50.0, 60.0]]]), (B, N, 1))
    boxes = random_boxes(rng, B, N, (400.0 if kind == "spread" else 60.0) * max(N, 64) / 1024, (5.0, 60.0))
    if kind == "nan":
        boxes[:, rng.integers(0, N, max(1, N // 20))] = np.nan
        boxes[-1, ::7, 2] = np.nan
    return boxes


@pytest.mark.gpu
@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("kind", ["spread", "crowded", "identical", "nan"])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 300, 1023, 1024, 1025, 1400, 2048, 4096])
def test_nms_keep_cluster_bit_exact(cuda, N, B, kind, thr):
    """The wrapper (one launch a call) and every placement of the conflict
    rows the kernel can take at N, at the wrapper's cluster size and at 8
    blocks (the walk local or the rows remote, or in global memory), bit-exact
    against the plain fixpoint on the card."""
    boxes = torch.from_numpy(keep_boxes(np.random.default_rng(N * 10 + B), B, N, kind)).to(cuda)
    want = nms_keep_mask_plain(boxes, thr)
    before = native.LAUNCHES["nms_keep"]
    got = nms_keep_mask(boxes, thr)
    torch.cuda.synchronize()
    assert native.LAUNCHES["nms_keep"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for cluster in sorted({nms_keep_plan(N)[1], min(8, -(-N // 32))}):
        for rows in ("local", "remote", "global"):
            if rows != "global" and nms_keep_smem_bytes(rows, N, cluster) > SMEM_OPTIN_BYTES:
                continue
            got = nms_keep_mask_cuda(boxes, thr, rows, cluster)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"{rows} cluster {cluster}")


@pytest.mark.gpu
def test_nms_keep_refused_launch_raises(cuda):
    """A cluster the kernel does not take (17 blocks) and rows past a block's
    shared memory are refused by the C entry point, and the wrapper raises
    rather than launch another variant."""
    boxes = torch.from_numpy(random_boxes(np.random.default_rng(3), 2, 2048)).to(cuda)
    assert nms_keep_plan(2048)[0] == "remote"
    with pytest.raises(RuntimeError):
        nms_keep_mask_cuda(boxes, 0.5, "local", 16)
    with pytest.raises(RuntimeError):
        nms_keep_mask_cuda(boxes, 0.5, "remote", 17)
    with pytest.raises(RuntimeError):
        nms_keep_mask_cuda(boxes.cpu(), 0.5, "remote", 16)


# a pyramid with levels large enough for long suppression chains
NMS_LEVELS = [(40, 60), (20, 30), (10, 15), (5, 8)]


def snake_path(h, w):
    """An h x w level's tokens on a path through rows 0, 2, 4, ..., joined
    at alternating ends by one cell of the row between: no two cells touch
    but neighbours on the path, so greedy NMS along it is one chain."""
    grid = torch.arange(h * w).view(h, w)
    parts = []
    for k, r in enumerate(range(0, h, 2)):
        parts.append(grid[r] if k % 2 == 0 else grid[r].flip(0))
        if r + 2 < h:
            parts.append(grid[r + 1, -1:] if k % 2 == 0 else grid[r + 1, :1])
    return torch.cat(parts)


def nms_order(case, seed=0):
    """(4, K) candidate orders over NMS_LEVELS: every token of level 0 in a
    random order; the first K tokens in raster order (chains about h + w
    rounds deep); ``snake_path`` on level 0, forwards and backwards (one
    chain of K); random draws over the pyramid."""
    g = torch.Generator().manual_seed(seed)
    h, w = NMS_LEVELS[0]
    S_ = sum(a * b for a, b in NMS_LEVELS)
    if case == "one_level":
        rows = [torch.randperm(h * w, generator=g) for _ in range(4)]
    elif case == "raster":
        rows = [torch.arange(1500)] * 4
    elif case == "snake":
        snake = snake_path(h, w)
        rows = [snake[:900], snake.flip(0)[:900], snake[100:1000], snake[:900].flip(0)]
    else:
        rows = [torch.randperm(S_, generator=g)[:1500] for _ in range(4)]
    return torch.stack(rows).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("case,num_out", [("one_level", 2400), ("one_level", 700), ("raster", 600),
                                          ("snake", 900), ("snake", 450), ("random", 1500), ("random", 900)])
def test_grid_nms_kernel_bit_exact_on_chain_orders(cuda, case, num_out):
    """Bit-exact against the plain fixpoint (run on the CPU) for orders whose
    chains are short (random), about h + w deep (raster) or as long as the
    candidate list (snake), and with every candidate on one level."""
    topk = nms_order(case)
    got = grid_nms_topk(topk.to(cuda).contiguous(), NMS_LEVELS, num_out)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), grid_nms_topk_plain(topk, NMS_LEVELS, num_out), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "raster"])
def test_grid_nms_kernel_past_shared_memory(cuda, case):
    """The 5-scale levels of a 1344 x 1344 canvas (S = 149,940): the rank map
    no longer fits beside K = 3600 candidates in shared memory, and the
    kernel's global-memory variant is bit-exact with the plain version."""
    levels = [(336, 336), (168, 168), (84, 84), (42, 42)]
    S_big = sum(h * w for h, w in levels)
    assert grid_nms_rank_in_global(3600, S_big) and not grid_nms_rank_in_global(3600, 89250)
    gen = torch.Generator().manual_seed(4)
    topk = torch.stack([torch.randperm(S_big, generator=gen)[:3600] for _ in range(3)]).to(torch.int32)
    if case == "raster":
        topk[1] = torch.arange(3600, dtype=torch.int32)
    before = native.LAUNCHES["grid_nms"]
    got = grid_nms_topk(topk.to(cuda).contiguous(), levels, 900)
    torch.cuda.synchronize()
    assert native.LAUNCHES["grid_nms"] == before + 1
    torch.testing.assert_close(got.cpu(), grid_nms_topk_plain(topk, levels, 900), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grid_nms_kernel_bit_exact_on_random_orders(cuda, seed):
    g = torch.Generator().manual_seed(100 + seed)
    S_ = sum(a * b for a, b in NMS_LEVELS)
    k = [40, 333, 1024, 3190][seed]
    topk = torch.stack([torch.randperm(S_, generator=g)[:k] for _ in range(3)]).to(torch.int32)
    for num_out in (k, k // 2 + 1):
        got = grid_nms_topk(topk.to(cuda).contiguous(), NMS_LEVELS, num_out)
        torch.testing.assert_close(got.cpu(), grid_nms_topk_plain(topk, NMS_LEVELS, num_out), rtol=0, atol=0)


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


# Inputs for the MSDA kernels at B=2, Q=8500: enough queries that the
# clustered case piles thousands of adds on a few rows.
BIG_LEVELS = [(150, 200), (120, 180)]  # not even one head's slice of a level fits shared memory


def shaped_inputs(case, device, dtype, G, C, H=8, B=2, Q=8500, P=4, seed=5):
    levels = BIG_LEVELS if case == "large_levels" else LEVELS
    L, S_ = len(levels), sum(h * w for h, w in levels)
    g = torch.Generator().manual_seed(seed)
    value = torch.randn(B, S_, C, generator=g)
    w = torch.rand(B, Q, H, L, P, generator=g)
    w = w / w.sum((-2, -1), keepdim=True)
    if case == "clustered":
        # every query on the same few pixel centres of each level: most
        # corners have weight 0 and the rest collide on a few rows
        locs = torch.empty(B, Q, G, L, P, 2)
        for lvl, (h, wd) in enumerate(levels):
            pick = torch.randint(0, 3, (B, Q, G, P, 2), generator=g)
            xs = (torch.tensor([0, wd // 2, wd - 1])[pick[..., 0]] + 0.5) / wd
            ys = (torch.tensor([0, h // 2, h - 1])[pick[..., 1]] + 0.5) / h
            locs[:, :, :, lvl, :, 0], locs[:, :, :, lvl, :, 1] = xs, ys
    elif case == "one_pixel":
        # every point of an image on one pixel centre of each level: a single
        # row takes all Q * P entries, the longest list a team can be given
        locs = torch.empty(B, Q, G, L, P, 2)
        for lvl, (h, wd) in enumerate(levels):
            locs[:, :, :, lvl, :, 0], locs[:, :, :, lvl, :, 1] = (wd // 3 + 0.5) / wd, (h // 2 + 0.5) / h
    elif case == "outside":  # beyond every level on at least one axis
        locs = torch.rand(B, Q, G, L, P, 2, generator=g) * 1.4 - 0.2
        far = torch.rand(B, Q, G, L, P, generator=g) * 2 + 1.3  # x * w - 0.5 >= w on every level
        side = torch.randint(0, 2, (B, Q, G, L, P), generator=g).bool()
        locs[..., 0] = torch.where(side, far, -far + 1)
    else:  # "uniform", "large_levels": a third of the points partly outside
        locs = torch.rand(B, Q, G, L, P, 2, generator=g) * 1.6 - 0.3
    return levels, value.to(device, dtype), locs.to(device), w.to(device)


# MSDA backward on the card, (atol as a share of the reference's largest
# magnitude, rtol): float32 sums by atomics and shuffles in other orders;
# bfloat16 d_value is one f32 sum rounded once on both sides (one ulp).
MSDA_GRAD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 1e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [32, 64, 256])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("case", ["uniform", "clustered", "outside", "large_levels"])
def test_msda_kernels_match_plain_on_shaped_inputs(cuda, case, G, C, dtype):
    """K1 and K3 against their plain versions at H=8 on uniform points,
    clustered pixel-centred points (zero-weight corners, heavy collisions),
    points outside every level (all outputs and gradients exactly 0) and
    levels too large to stage in shared memory."""
    levels, value, locs, w = shaped_inputs(case, cuda, dtype, G, C)
    d_out = torch.randn(value.shape[0], locs.shape[1], C, device=cuda).to(dtype)
    inputs = [x.clone().requires_grad_() for x in (value, locs, w)]
    before = dict(native.LAUNCHES)
    out = ms_deform_attn(inputs[0], levels, inputs[1], inputs[2])
    out.backward(d_out)
    torch.cuda.synchronize()
    assert native.LAUNCHES["msda"] == before["msda"] + 1
    assert native.LAUNCHES["msda_backward"] == before["msda_backward"] + 1
    atol, rtol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (4e-3, 1e-2)}[dtype]
    want = ms_deform_attn_plain(value, levels, locs, w)
    torch.testing.assert_close(out.detach().float(), want.float(), rtol=rtol, atol=atol)
    grads = ms_deform_attn_backward_plain(value, levels, locs, w, d_out)
    for name, x, ref in zip(("d_value", "d_locations", "d_weights"), inputs, grads):
        share, rtol = MSDA_GRAD_TOL[dtype] if name == "d_value" else MSDA_GRAD_TOL[torch.float32]
        ref = ref.float()
        torch.testing.assert_close(x.grad.float(), ref, rtol=rtol,
                                   atol=share * float(ref.abs().max()) + 1e-30, msg=name)
    if case == "outside":
        assert not bool(out.detach().float().abs().any())
        assert all(not bool(x.grad.float().abs().any()) for x in inputs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [32, 256])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("case", ["uniform", "clustered", "one_pixel", "outside", "large_levels"])
def test_msda_backward_ordered_matches_plain_and_repeats(cuda, case, G, C, dtype):
    """K3's ordered design (under ``torch.use_deterministic_algorithms``, no
    float atomics): through autograd it launches once under its own key,
    two launches are bitwise equal, and it holds K3's tolerances against
    the plain backward, on the shaped inputs (rows of thousands of
    entries) and on one pixel (a row of Q * P entries, summed by one team
    of lanes)."""
    levels, value, locs, w = shaped_inputs(case, cuda, dtype, G, C)
    d_out = torch.randn(value.shape[0], locs.shape[1], C, device=cuda).to(dtype)
    inputs = [x.clone().requires_grad_() for x in (value, locs, w)]
    before = dict(native.LAUNCHES)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        assert backward_design() == "ordered"
        ms_deform_attn(inputs[0], levels, inputs[1], inputs[2]).backward(d_out)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    assert native.LAUNCHES["msda_backward_ordered"] == before["msda_backward_ordered"] + 1
    assert native.LAUNCHES["msda_backward"] == before["msda_backward"]
    again = _backward_cuda_ordered(value, levels, locs, w, d_out)
    for name, x, g in zip(("d_value", "d_locations", "d_weights"), inputs, again):
        assert torch.equal(x.grad, g), name
    grads = ms_deform_attn_backward_plain(value, levels, locs, w, d_out)
    for name, x, ref in zip(("d_value", "d_locations", "d_weights"), inputs, grads):
        assert x.grad.dtype == ref.dtype, name
        share, rtol = MSDA_GRAD_TOL[dtype] if name == "d_value" else MSDA_GRAD_TOL[torch.float32]
        ref = ref.float()
        torch.testing.assert_close(x.grad.float(), ref, rtol=rtol,
                                   atol=share * float(ref.abs().max()) + 1e-30, msg=name)


# the ordered K3 at the ported train steps' row counts (B = 4): the
# flagship's encoder (17-bit rows) and decoder (20-bit), the 5-scale
# config's exact encoder (22-bit)
ORDERED_ROW_SHAPES = {
    "17-bit rows": ([(100, 168), (50, 84), (25, 42), (13, 21)], 1),
    "20-bit rows": ([(100, 168), (50, 84), (25, 42), (13, 21)], 8),
    "22-bit rows": ([(200, 336), (100, 168), (50, 84), (25, 42)], 8),
}


def baseline_ordered_library():
    """K3 built from the directory SALIENCE_BASELINE_CSRC names (another
    version of csrc/, e.g. the parent commit's), or None when it names none."""
    import ctypes
    import os
    from pathlib import Path

    base_dir = os.environ.get("SALIENCE_BASELINE_CSRC")
    if not base_dir:
        return None
    lib = native.bind_msda(ctypes.CDLL(str(native.build(Path(base_dir).resolve()))))
    assert hasattr(lib, "msda_backward_ordered"), f"{base_dir} has no ordered K3"
    return lib


def ordered_call(lib, value, levels, locs, w, d_out):
    """One call of ``lib``'s ordered K3 (its own workspace size): d_value,
    d_locations, d_weights."""
    B, S_, C = value.shape
    Q, G, L, P = locs.shape[1:5]
    H = w.shape[2]
    table = native.level_table(levels)
    workspace = torch.empty(lib.msda_backward_workspace(table, B, S_, Q, C, H, G, P), dtype=torch.uint8,
                            device=value.device)
    d_value = torch.empty_like(value)
    d_loc = torch.empty(B, Q, G, L, P, 2, device=value.device)
    d_attn = torch.empty(B, Q, H, L, P, device=value.device)
    err = lib.msda_backward_ordered(value.data_ptr(), int(value.dtype == torch.bfloat16), table,
                                    locs.float().contiguous().data_ptr(), w.float().contiguous().data_ptr(),
                                    d_out.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(), d_attn.data_ptr(),
                                    workspace.data_ptr(), B, S_, Q, C, H, G, P, native.stream_of(value))
    native.check(err, "msda_backward_ordered")
    torch.cuda.synchronize()
    return d_value, d_loc, d_attn


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(ORDERED_ROW_SHAPES))
def test_msda_backward_ordered_at_the_ported_row_counts(cuda, shape, dtype):
    """The ordered K3 at the train steps' row counts (B = 4, C = 256, H = 8,
    1200 queries): within K3's tolerances of the plain backward, two calls
    bitwise equal, and, with SALIENCE_BASELINE_CSRC naming the parent
    commit's csrc/, bitwise equal to that directory's ordered design
    (d_value, d_locations, d_weights)."""
    levels, G = ORDERED_ROW_SHAPES[shape]
    S_ = sum(h * w_ for h, w_ in levels)
    g = torch.Generator().manual_seed(18)
    value = torch.randn(4, S_, 256, generator=g).to(cuda, dtype)
    w = torch.rand(4, 1200, 8, len(levels), 4, generator=g)
    w = (w / w.sum((-2, -1), keepdim=True)).to(cuda)
    locs = (torch.rand(4, 1200, G, len(levels), 4, 2, generator=g) * 1.2 - 0.1).to(cuda)
    d_out = torch.randn(4, 1200, 256, generator=g).to(cuda, dtype)
    got = _backward_cuda_ordered(value, levels, locs, w, d_out)
    again = _backward_cuda_ordered(value, levels, locs, w, d_out)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    grads = ms_deform_attn_backward_plain(value, levels, locs, w, d_out)
    for name, x, ref in zip(("d_value", "d_locations", "d_weights"), got, grads):
        share, rtol = MSDA_GRAD_TOL[dtype] if name == "d_value" else MSDA_GRAD_TOL[torch.float32]
        ref = ref.float()
        torch.testing.assert_close(x.float(), ref, rtol=rtol, atol=share * float(ref.abs().max()) + 1e-30,
                                   msg=name)
    base = baseline_ordered_library()
    if base is not None:
        mine = ordered_call(native.load(), value, levels, locs, w, d_out)
        theirs = ordered_call(base, value, levels, locs, w, d_out)
        assert [torch.equal(a, b) for a, b in zip(mine, theirs)] == [True] * 3
        assert all(torch.equal(a, b) for a, b in zip(mine, got))


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


def total_cost(cost, match, valid):
    """Each image's cost of its matching, in float64 on the host."""
    cost, match, valid = cost.double().cpu(), match.long().cpu(), valid.cpu()
    out = []
    for b in range(cost.shape[0]):
        cols = torch.nonzero(valid[b])[:, 0]
        assert len(set(match[b, cols].tolist())) == len(cols) and bool((match[b, cols] >= 0).all())
        assert bool((match[b][~valid[b]] == -1).all())
        out.append(float(cost[b, match[b, cols], cols].sum()))
    return out


@pytest.mark.gpu
def test_hungarian_kernel_batched_sets_with_ties(cuda):
    """Seven sets of four images in one launch, integer costs with many tied
    optima: every image gets a matching of the plain version's optimal total,
    and the same one as in a launch of its own set."""
    g = torch.Generator().manual_seed(6)
    sets, B, N, M = 7, 4, 120, 25
    cost = torch.randint(0, 4, (sets * B, N, M), generator=g).float().to(cuda)
    counts = torch.tensor([25, 7, 0, 1] * sets).view(-1, 1)
    valid = (torch.arange(M)[None] < counts).to(cuda)
    before = native.LAUNCHES["hungarian"]
    got = batched_assignment(cost, valid)
    torch.cuda.synchronize()
    assert native.LAUNCHES["hungarian"] == before + 1
    per_set = torch.cat([batched_assignment(cost[s * B:(s + 1) * B], valid[s * B:(s + 1) * B])
                         for s in range(sets)])
    torch.testing.assert_close(got, per_set, rtol=0, atol=0)
    want = batched_assignment_plain(cost, valid)
    assert total_cost(cost, got, valid) == total_cost(cost, want, valid)


@pytest.mark.gpu
def test_hungarian_kernel_rows_past_shared_memory(cuda):
    """100 valid gts at N=901 (rows padded to 904 floats): about 60 rows are
    staged in shared memory and the rest read from device memory; an image
    with no valid gt beside it reports -1 everywhere."""
    g = torch.Generator().manual_seed(7)
    cost = (torch.rand(3, 901, 100, generator=g) * 30 - 5).to(cuda)
    valid = (torch.arange(100)[None] < torch.tensor([[100], [0], [63]])).to(cuda)
    got = batched_assignment(cost, valid)
    torch.cuda.synchronize()
    assert bool((got[1] == -1).all())
    torch.testing.assert_close(got, batched_assignment_plain(cost, valid), rtol=0, atol=0)


@pytest.mark.gpu
def test_hungarian_kernel_nan_set_reports_only_its_image(cuda):
    """In a launch of seven sets, one image with NaN costs reports -1 for all
    its gts; every other image matches the plain version."""
    g = torch.Generator().manual_seed(8)
    cost = (torch.rand(28, 90, 12, generator=g) * 10).to(cuda)
    cost[13] = float("nan")
    valid = (torch.arange(12)[None] < torch.tensor([12, 5, 9, 1] * 7).view(-1, 1)).to(cuda)
    got = batched_assignment(cost, valid)
    torch.cuda.synchronize()
    assert bool((got[13] == -1).all())
    keep = torch.tensor([b for b in range(28) if b != 13], device=cuda)
    torch.testing.assert_close(got[keep], batched_assignment_plain(cost[keep], valid[keep]), rtol=0, atol=0)


def mixed_query_sets(match, valid):
    """{(image, gt): sorted queries of its valid copies} on the host."""
    match, valid = match.cpu(), valid.cpu()
    B, C, M = match.shape
    return {(b, g): sorted(match[b, valid[b, :, g], g].tolist()) for b in range(B) for g in range(M)}


def mixed_totals(cost, match, valid):
    """Each image's cost of its mixed matching, in float64 on the host; every
    valid copy holds a distinct query, every other slot -1."""
    cost, match, valid = cost.double().cpu(), match.long().cpu(), valid.cpu()
    out = []
    for b in range(cost.shape[0]):
        used = match[b][valid[b]]
        assert len(set(used.tolist())) == len(used) and bool((used >= 0).all())
        assert bool((match[b][~valid[b]] == -1).all())
        g = torch.nonzero(valid[b])[:, 1]
        out.append(float(cost[b, used, g].sum()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("copies", [2, 10])
def test_hungarian_mixed_kernel_matches_plain(cuda, copies):
    """The mixed assignment in one launch against the plain version over the
    tiled columns: the same queries for each gt and equal totals (which copy
    takes which query is a tie).  At C = 10, C * M = 250 > N = 120, and one
    image's 70 valid gts leave it no copy (70 > N // 2)."""
    g = torch.Generator().manual_seed(20 + copies)
    cost = (torch.rand(5, 120, 25, generator=g) * 40 - 10).to(cuda)
    counts = torch.tensor([[25], [7], [0], [1], [25]])
    valid = (torch.arange(25)[None] < counts).to(cuda)
    before = native.LAUNCHES["hungarian"]
    got, got_valid = batched_mixed_assignment(cost, valid, copies)
    torch.cuda.synchronize()
    assert native.LAUNCHES["hungarian"] == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (5, copies, 25)
    want, want_valid = batched_mixed_assignment_plain(cost, valid, copies)
    assert torch.equal(got_valid, want_valid)
    assert mixed_query_sets(got, got_valid) == mixed_query_sets(want, want_valid)
    assert mixed_totals(cost, got, got_valid) == mixed_totals(cost, want, want_valid)
    # rows past N: 70 valid gts of 70 slots at N = 120 take no copy
    wide = (torch.rand(2, 120, 70, generator=g) * 10).to(cuda)
    wide_valid = (torch.arange(70)[None] < torch.tensor([[70], [12]])).to(cuda)
    m, v = batched_mixed_assignment(wide, wide_valid, copies)
    assert not bool(v[0].any()) and bool((m[0] == -1).all())
    pm, pv = batched_mixed_assignment_plain(wide, wide_valid, copies)
    assert mixed_query_sets(m, v) == mixed_query_sets(pm, pv)


@pytest.mark.gpu
def test_hungarian_mixed_kernel_one_launch_for_seven_sets(cuda):
    """Seven sets of four images stacked into one mixed launch (as the
    criterion's match_sets does) equal to a launch of each set."""
    g = torch.Generator().manual_seed(30)
    sets, B, N, M, C = 7, 4, 300, 40, 3
    cost = (torch.rand(sets * B, N, M, generator=g) * 20).to(cuda)
    valid = (torch.arange(M)[None] < torch.tensor([40, 7, 0, 1] * sets).view(-1, 1)).to(cuda)
    before = native.LAUNCHES["hungarian"]
    got, got_valid = batched_mixed_assignment(cost, valid, C)
    torch.cuda.synchronize()
    assert native.LAUNCHES["hungarian"] == before + 1
    for s in range(sets):
        part, part_valid = batched_mixed_assignment(cost[s * B:(s + 1) * B], valid[s * B:(s + 1) * B], C)
        assert torch.equal(part_valid, got_valid[s * B:(s + 1) * B])
        assert mixed_query_sets(part, part_valid) == mixed_query_sets(got[s * B:(s + 1) * B], part_valid)
    want, want_valid = batched_mixed_assignment_plain(cost, valid, C)
    assert mixed_totals(cost, got, got_valid) == mixed_totals(cost, want, want_valid)


@pytest.mark.gpu
def test_hungarian_kernel_valid_rows_past_queries_raise(cuda):
    """More gt slots than queries is taken while every image's valid gts fit
    its queries; an image with more valid gts than queries raises before the
    launch."""
    g = torch.Generator().manual_seed(31)
    cost = (torch.rand(3, 20, 30, generator=g) * 10).to(cuda)
    valid = (torch.arange(30)[None] < torch.tensor([[20], [5], [0]])).to(cuda)
    got = batched_assignment(cost, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, batched_assignment_plain(cost, valid), rtol=0, atol=0)
    before = native.LAUNCHES["hungarian"]
    valid[1, :21] = True
    with pytest.raises(ValueError, match="21 valid gts"):
        batched_assignment(cost, valid)
    assert native.LAUNCHES["hungarian"] == before


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


def gather_cluster_inputs(device, pattern, T, G=64, seed=14):
    """value (2, S, 4, 32) bf16 with row 0 zero and idx (2, 4, 37, G) int32:
    all in the last T rows, all before them, or both with indices outside
    [0, S); with the same idx where out-of-range ones are 0 (what skipping
    them gives over the zero row)."""
    g = torch.Generator().manual_seed(seed)
    value = torch.randn(2, S, 4, 32, generator=g)
    value[:, 0] = 0
    lo, hi = {"inside": (S - max(T, 1), S), "outside": (0, max(S - T, 1)), "mixed": (0, S)}[pattern]
    idx = torch.randint(lo, hi, (2, 4, 37, G), generator=g, dtype=torch.int32)
    clean = idx.clone()
    if pattern == "mixed":
        idx[0, 0, 0, :3] = torch.tensor([-1, S, 1 << 30], dtype=torch.int32)
        clean[0, 0, 0, :3] = 0
    return value.to(device, torch.bfloat16), idx.to(device), clean.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["inside", "outside", "mixed"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [0, 50, S])
def test_gather_cluster_matches_shipped_gather_sum(cuda, T, cluster, pattern):
    """The cluster-staged design (salience_detr_torch/tools/gather_cluster)
    at T = 0, a tail in between and T = S, over 1-8 blocks and 1-3 query
    ranges: bitwise equal to the shipped K5 (the same f32 order), within
    stage_close of the plain version, and bitwise repeatable."""
    value, idx, clean = gather_cluster_inputs(cuda, pattern, T)
    for qsplit in (1, 3):
        got = gather_cluster.gather_sum_staged(value, idx, T, cluster, qsplit)
        again = gather_cluster.gather_sum_staged(value, idx, T, cluster, qsplit)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got, st.gather_sum(value, idx))
        stage_close(got, st.gather_sum_plain(value, clean), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [70, 5])
def test_gather_cluster_ragged_and_rejected(cuda, G):
    """Ragged G with out-of-range indices, bitwise equal to the shipped K5;
    D != 32, a tail past S or past a block's shared memory, and 9 blocks
    raise."""
    value, idx, clean = gather_cluster_inputs(cuda, "mixed", S // 2, G)
    got = gather_cluster.gather_sum_staged(value, idx, S // 2, 3, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, st.gather_sum(value, idx))
    stage_close(got, st.gather_sum_plain(value, clean), torch.bfloat16)
    with pytest.raises(ValueError):
        gather_cluster.gather_sum_staged(value[..., :24].contiguous(), idx, 0, 1, 1)
    with pytest.raises(ValueError):
        gather_cluster.gather_sum_staged(value, idx, S + 1, 1, 1)
    with pytest.raises(ValueError):
        gather_cluster.gather_sum_staged(value, idx, S, 9, 1)
    big = torch.zeros(1, 4000, 1, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gather_cluster.gather_sum_staged(big, idx[:1, :1].contiguous(), 4000, 1, 1)


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


# ---------------------------------------------------------------- DCNv2 sampling and the int8 MSDA


def dcn_inputs(device, dtype, stride, C, B=2, H=13, W=17, seed=13):
    """x normal; offsets normal with std 2 pixels (off the grid, some taps
    outside the image); mask uniform in (0, 1)."""
    g = torch.Generator().manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(B, H, W, C, generator=g).to(device, dtype)
    offsets = (2 * torch.randn(B, Ho, Wo, 18, generator=g)).to(device)
    mask = torch.rand(B, Ho, Wo, 9, generator=g).to(device)
    return x, offsets, mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,C", [(1, 32), (2, 64), (1, 128), (2, 256), (1, 512)])
def test_deform_conv_kernels_match_plain(cuda, dtype, stride, C):
    """Forward: the plain version's operations one for one, so equal up to
    the last bit (held at the MSDA forward's tolerance).  Backward against
    the plain backward and autograd of the plain forward, max |d| <= atol *
    max |ref| + rtol |ref| (BWD tolerances: atomics and lane sums in other
    orders); without a gradient for x the scatter is skipped."""
    from salience_detr_torch.ops.deform_conv import (
        deform_conv_sample,
        deform_conv_sample_backward_plain,
        deform_conv_sample_plain,
    )

    x, offsets, mask = dcn_inputs(cuda, dtype, stride, C)
    before = dict(native.LAUNCHES)
    got = deform_conv_sample(x, offsets, mask, stride)
    torch.cuda.synchronize()
    assert native.LAUNCHES["deform_conv"] == before["deform_conv"] + 1
    atol, rtol = (1e-5, 1e-4) if dtype == torch.float32 else (4e-3, 1e-2)
    torch.testing.assert_close(got, deform_conv_sample_plain(x, offsets, mask, stride), atol=atol, rtol=rtol)

    d_cols = torch.randn(got.shape, generator=torch.Generator().manual_seed(14)).to(cuda, dtype)
    inputs = [t.clone().requires_grad_() for t in (x, offsets, mask)]
    deform_conv_sample(*inputs, stride).backward(d_cols)
    torch.cuda.synchronize()
    assert native.LAUNCHES["deform_conv_backward"] == before["deform_conv_backward"] + 1
    plain = deform_conv_sample_backward_plain(x, offsets, mask, stride, d_cols)
    auto = [t.clone().requires_grad_() for t in (x, offsets, mask)]
    deform_conv_sample_plain(*auto, stride).backward(d_cols)
    for refs in (plain, [a.grad for a in auto]):
        for g, r in zip((i.grad for i in inputs), refs):
            atol_rel, rtol_b = (1e-5, 1e-4) if r.dtype == torch.float32 else (1e-3, 1e-2)
            err = (g.float() - r.float()).abs()
            assert bool((err <= atol_rel * r.float().abs().max() + rtol_b * r.float().abs()).all())
    off, msk = offsets.clone().requires_grad_(), mask.clone().requires_grad_()
    deform_conv_sample(x, off, msk, stride).backward(d_cols)
    torch.testing.assert_close(off.grad, inputs[1].grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(msk.grad, inputs[2].grad, atol=1e-5, rtol=1e-4)


def dcn_backward_refs(x, offsets, mask, stride, d_cols):
    """The plain backward and autograd of the plain forward."""
    from salience_detr_torch.ops.deform_conv import deform_conv_sample_backward_plain, deform_conv_sample_plain

    auto = [t.clone().requires_grad_() for t in (x, offsets, mask)]
    deform_conv_sample_plain(*auto, stride).backward(d_cols)
    return deform_conv_sample_backward_plain(x, offsets, mask, stride, d_cols), [a.grad for a in auto]


def assert_dcn_grads_close(got, refs):
    """max |d| <= atol * max |ref| + rtol |ref| per gradient, at the MSDA
    backward's tolerances by the gradient's dtype."""
    for ref in refs:
        for name, g, r in zip(("d_x", "d_offsets", "d_mask"), got, ref):
            assert g.dtype == r.dtype, name
            atol_rel, rtol = (1e-5, 1e-4) if r.dtype == torch.float32 else (1e-3, 1e-2)
            err = (g.float() - r.float()).abs()
            assert bool((err <= atol_rel * r.float().abs().max() + rtol * r.float().abs()).all()), name


def dcn_offsets_case(case, offsets):
    """Offsets of one kind: on pixel borders (integers: zero-weight corners),
    far beyond any neighbourhood (+-20 px), every tap outside the image."""
    g = torch.Generator().manual_seed(16)
    if case == "integer":
        return offsets.round()
    if case == "far":
        return ((torch.rand(offsets.shape, generator=g) * 40 - 20)).to(offsets.device)
    if case == "outside":
        return torch.full_like(offsets, -500.0)
    return offsets


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("C", [32, 64, 128, 256, 512])
def test_deform_conv_backward_gather_matches_plain(cuda, dtype, stride, C):
    """The gather backward through autograd (one counted launch) against the
    plain backward and autograd of the plain forward; d_x in x's dtype and
    bitwise equal over two calls."""
    from salience_detr_torch.ops.deform_conv import _backward_cuda, deform_conv_sample

    x, offsets, mask = dcn_inputs(cuda, dtype, stride, C, H=19, W=23)
    d_cols = torch.randn(*offsets.shape[:3], 9, C, generator=torch.Generator().manual_seed(17)).to(cuda, dtype)
    inputs = [t.clone().requires_grad_() for t in (x, offsets, mask)]
    before = native.LAUNCHES["deform_conv_backward"]
    deform_conv_sample(*inputs, stride).backward(d_cols)
    torch.cuda.synchronize()
    assert native.LAUNCHES["deform_conv_backward"] == before + 1
    assert_dcn_grads_close([i.grad for i in inputs], dcn_backward_refs(x, offsets, mask, stride, d_cols))
    first, second = (_backward_cuda(x, offsets, mask, stride, d_cols) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["integer", "far", "outside"])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_backward_gather_any_offsets(cuda, case, stride):
    """Taps exactly on pixels and so on tile and halo borders, taps +-20 px
    away, and every tap outside the image (all gradients 0), in bf16 at
    C=128; x without a gradient (no d_x written) gives the same d_offsets
    and d_mask."""
    from salience_detr_torch.ops.deform_conv import _backward_cuda

    x, offsets, mask = dcn_inputs(cuda, torch.bfloat16, stride, 128, H=21, W=37)
    offsets = dcn_offsets_case(case, offsets)
    d_cols = torch.randn(*offsets.shape[:3], 9, 128, generator=torch.Generator().manual_seed(18)).to(
        cuda, torch.bfloat16)
    got = _backward_cuda(x, offsets, mask, stride, d_cols)
    torch.cuda.synchronize()
    assert_dcn_grads_close(got, dcn_backward_refs(x, offsets, mask, stride, d_cols))
    if case == "outside":
        assert not any(bool(g.any()) for g in got)
    none, d_off, d_mask = _backward_cuda(x, offsets, mask, stride, d_cols, need_x=False)
    assert none is None and torch.equal(d_off, got[1]) and torch.equal(d_mask, got[2])


@pytest.mark.gpu
def test_deform_conv_backward_gather_long_lists(cuda):
    """Offsets that pile every tap of a 12x12 output onto one 2x2 corner
    block: lists of 1296 keys take the selection path, in key order all the
    same (d_x bitwise repeatable)."""
    from salience_detr_torch.ops.deform_conv import _backward_cuda, _tap_positions

    x, offsets, mask = dcn_inputs(cuda, torch.float32, 1, 64, B=1, H=12, W=12)
    base_y, base_x = (p - o for p, o in zip(_tap_positions(offsets, 1), (offsets[..., 0::2], offsets[..., 1::2])))
    offsets = torch.stack([5.25 - base_y, 6.5 - base_x], -1).reshape(offsets.shape).contiguous()
    d_cols = torch.randn(1, 12, 12, 9, 64, generator=torch.Generator().manual_seed(19)).to(cuda)
    first, second = (_backward_cuda(x, offsets, mask, 1, d_cols) for _ in range(2))
    torch.cuda.synchronize()
    assert_dcn_grads_close(first, dcn_backward_refs(x, offsets, mask, 1, d_cols))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert int((first[0].abs().sum(-1) > 0).sum()) == 4


@pytest.mark.gpu
def test_deform_conv_kernels_reject_what_they_cannot_take(cuda):
    """The columns kernel's C set, dtypes and layout; the layer's two CUDA
    routes take the same Cin set (C = 96 is a multiple of 32 but not in it),
    so that a layer whose forward runs can also run its backward's
    recompute."""
    from salience_detr_torch.ops.deform_conv import deform_conv2d, deform_conv_sample

    x, offsets, mask = dcn_inputs(cuda, torch.bfloat16, 1, 64)
    x96 = torch.cat([x, x[..., :32]], -1).contiguous()
    before = dict(native.LAUNCHES)
    for F in (96, 256):  # the fused route and the columns route
        with pytest.raises(ValueError):
            deform_conv2d(x96, offsets, mask, torch.zeros(9, 96, F, device=cuda), 1)
    assert native.LAUNCHES == before
    with pytest.raises(TypeError):
        deform_conv_sample(x.double(), offsets, mask, 1)
    with pytest.raises(ValueError):
        deform_conv_sample(x[..., :48].contiguous(), offsets, mask, 1)  # C=48
    with pytest.raises(ValueError):
        deform_conv_sample(x.transpose(1, 2), offsets, mask, 1)  # not channels-last contiguous
    with pytest.raises(ValueError):
        deform_conv_sample(x, offsets, mask, 2)  # offsets of a stride-1 layer


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H,C", [(8, 256), (4, 32), (4, 128), (1, 256), (16, 256), (32, 256), (2, 64), (8, 64),
                                 (8, 512), (1, 16), (32, 128), (8, 32), (32, 64), (32, 32)])
def test_msda_q8_kernels_match_plain(cuda, dtype, H, C):
    """The int8 table and scale bit-exact with the plain quantisation; the
    sampler bit-exact with the plain sampling on the same table (the same
    IEEE operations in the same order), at borders and in a 1-wide level;
    every lane width (16, 8, 4, 2 and 1 int8 channels) among the cases."""
    from salience_detr_torch.ops.deform_attn import (
        ms_deform_attn_q8,
        ms_deform_attn_q8_plain,
        q8_quantize,
        q8_quantize_plain,
        q8_sample,
        q8_sample_plain,
    )

    levels = LEVELS[:3] + [(4, 1)]
    g = torch.Generator().manual_seed(15)
    B, Q, P = 2, 41, 4
    value = (torch.randn(B, sum(h * w for h, w in levels), C, generator=g) * 3).to(cuda, dtype)
    locs = (torch.rand(B, Q, len(levels), P, 2, generator=g) * 1.6 - 0.3).to(cuda)
    w = torch.rand(B, Q, H, len(levels), P, generator=g)
    w = (w / w.sum((-2, -1), keepdim=True)).to(cuda, dtype)
    before = dict(native.LAUNCHES)
    table, scale = q8_quantize(value)
    want_table, want_scale = q8_quantize_plain(value)
    torch.cuda.synchronize()
    assert torch.equal(table, want_table) and torch.equal(scale, want_scale)
    got = q8_sample(table, scale, levels, locs, w, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, q8_sample_plain(table, scale, levels, locs, w, dtype))
    assert torch.equal(ms_deform_attn_q8(value, levels, locs, w), ms_deform_attn_q8_plain(value, levels, locs, w))
    assert native.LAUNCHES["msda_q8_quantize"] == before["msda_q8_quantize"] + 2
    assert native.LAUNCHES["msda_q8_sample"] == before["msda_q8_sample"] + 2


@pytest.mark.gpu
def test_msda_q8_float16_rounds_subnormal_corner_weights_as_plain(cuda):
    """ROADMAP C-29: points 2^-10 to 2^-9 of a pixel past a pixel centre on
    both axes give corner weights of about 1e-6, float16 subnormals; the
    float16 sampler rounds them as ``.to(torch.float16)`` does, bit for bit
    with the plain version, through the registered operators."""
    from salience_detr_torch.ops.deform_attn import ms_deform_attn_q8, ms_deform_attn_q8_plain

    levels = LEVELS[:3] + [(4, 1)]
    g = torch.Generator().manual_seed(16)
    B, Q, P, H, C = 2, 37, 4, 8, 256
    value = (torch.randn(B, sum(h * w for h, w in levels), C, generator=g) * 3).to(cuda, torch.float16)
    locs = torch.empty(B, Q, len(levels), P, 2)
    for lvl, (h, w_) in enumerate(levels):
        for axis, size in ((0, w_), (1, h)):
            pixel = torch.randint(-1, size + 1, (B, Q, P), generator=g).float()
            frac = 2.0 ** -10 * (1 + torch.rand(B, Q, P, generator=g))
            locs[:, :, lvl, :, axis] = (pixel + frac + 0.5) / size
    w = torch.rand(B, Q, H, len(levels), P, generator=g)
    w = (w / w.sum((-2, -1), keepdim=True)).to(cuda, torch.float16)
    locs = locs.to(cuda)
    before = dict(native.LAUNCHES)
    got = ms_deform_attn_q8(value, levels, locs, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16 and torch.equal(got, ms_deform_attn_q8_plain(value, levels, locs, w))
    assert native.LAUNCHES["msda_q8_sample"] == before["msda_q8_sample"] + 1


@pytest.mark.gpu
def test_b6_b8_operators_launch_the_kernels(cuda):
    """The registered operators of B6 and B8 on CUDA tensors launch their
    kernels (one count each) and equal the plain versions as the wrappers'
    tests hold them: B8 bitwise, B6 columns bitwise, the fused layer within
    one bf16 ulp of the plain layer (its product runs on the tensor cores)."""
    from salience_detr_torch.ops import deform_attn, deform_conv

    ops = torch.ops.salience_detr
    g = torch.Generator().manual_seed(17)
    x = torch.randn(2, 20, 24, 128, generator=g).to(cuda, torch.bfloat16)
    off = torch.randn(2, 20, 24, 18, generator=g).to(cuda)
    msk = torch.rand(2, 20, 24, 9, generator=g).to(cuda)
    weight = (torch.randn(9, 128, 128, generator=g) / 32).to(cuda)
    before = dict(native.LAUNCHES)
    cols = ops.deform_conv_columns(x, off, msk, 1)
    fused = ops.deform_conv_fused(x, off, msk, weight, 1)
    unfused = ops.deform_conv_unfused(x, off, msk, weight, 1)
    d_x, d_off, d_mask = ops.deform_conv_backward(x, off, msk, cols, 1, True)
    torch.cuda.synchronize()
    assert torch.equal(cols, deform_conv.deform_conv_sample_plain(x, off, msk, 1))
    plain = deform_conv.deform_conv2d_plain(x, off, msk, weight, 1).float()
    assert torch.allclose(fused.float(), plain, atol=4e-3, rtol=1e-2)
    assert torch.allclose(unfused.float(), plain, atol=4e-3, rtol=1e-2)
    assert d_x.shape == x.shape and d_off.shape == off.shape and d_mask.shape == msk.shape
    value = torch.randn(2, sum(h * w for h, w in LEVELS), 256, generator=g).to(cuda, torch.bfloat16)
    locs = torch.rand(2, 50, len(LEVELS), 4, 2, generator=g).to(cuda)
    w = torch.rand(2, 50, 8, len(LEVELS), 4, generator=g).to(cuda, torch.bfloat16)
    table, scale = ops.q8_quantize(value)
    out = ops.q8_sample(table, scale, locs, w, [n for hw in LEVELS for n in hw], torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(out, deform_attn.q8_sample_plain(*deform_attn.q8_quantize_plain(value), LEVELS, locs, w,
                                                        torch.bfloat16))
    after = {k: native.LAUNCHES[k] - before[k] for k in native.LAUNCHES}
    assert {k: v for k, v in after.items() if v} == {"deform_conv": 2, "deform_conv_fused": 1,
                                                     "deform_conv_backward": 1, "msda_q8_quantize": 1,
                                                     "msda_q8_sample": 1}


@pytest.mark.gpu
def test_msda_q8_sampler_rejects_what_it_cannot_take(cuda):
    """H must divide C, and C / CPL lanes a query must divide 32 (CPL the
    largest of 16, 8, 4, 2, 1 dividing C / H)."""
    from salience_detr_torch.ops.deform_attn import q8_sample

    levels = [(4, 5), (2, 3)]
    for H, C in ((64, 256), (3, 48), (8, 1024)):
        table = torch.zeros(1, 26, C, dtype=torch.int8, device=cuda)
        locs = torch.rand(1, 3, 2, 4, 2, device=cuda)
        w = torch.rand(1, 3, H, 2, 4, device=cuda)
        with pytest.raises(ValueError):
            q8_sample(table, torch.ones(C, device=cuda), levels, locs, w, torch.bfloat16)


# the R50-DCN layers at B=4 on the 800x1344 canvas (Cin, input height,
# width, stride), then narrow Cin at small sizes
DCN_COLUMN_SHAPES = [(128, 200, 336, 2), (128, 100, 168, 1), (256, 100, 168, 2), (256, 50, 84, 1),
                     (512, 50, 84, 2), (512, 25, 42, 1), (32, 30, 41, 1), (64, 31, 40, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("C,H,W,stride", DCN_COLUMN_SHAPES)
def test_deform_conv_columns_bit_equal_to_plain(cuda, C, H, W, stride, dtype):
    """The columns kernel is the plain version's operations one for one:
    equal to it in every element, at every lane layout (4, 8, 16 and 32
    lanes a pixel, 1, 2 and 4 channel chunks), one counted launch."""
    from salience_detr_torch.ops.deform_conv import deform_conv_sample, deform_conv_sample_plain

    x, offsets, mask = dcn_inputs(cuda, dtype, stride, C, B=4 if H > 31 else 2, H=H, W=W, seed=C + H)
    before = native.LAUNCHES["deform_conv"]
    got = deform_conv_sample(x, offsets, mask, stride)
    torch.cuda.synchronize()
    assert native.LAUNCHES["deform_conv"] == before + 1
    assert torch.equal(got, deform_conv_sample_plain(x, offsets, mask, stride))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_columns_on_nonfinite_rows(cuda, stride, dtype):
    """inf and NaN in the top-right and bottom-right pixels, which only the
    clamped addresses of corners outside the image reach (the right half's
    taps lie beyond the image; the left half's offsets stay within 1 px):
    the kernel weighs them 0 as the plain version does, NaN where it has NaN
    (0 * inf) and equal elsewhere."""
    from salience_detr_torch.ops.deform_conv import deform_conv_sample, deform_conv_sample_plain

    C, H, W = 64, 9, 11
    x, offsets, mask = dcn_inputs(cuda, dtype, stride, C, H=H, W=W, seed=23)
    pairs = offsets.clamp(-1, 1).reshape(*offsets.shape[:-1], 9, 2)
    right = torch.arange(offsets.shape[2], device=cuda) >= offsets.shape[2] // 2
    far_y = torch.where(torch.arange(9, device=cuda) % 2 == 0, -30.5, H + 30.5)
    pairs[:, :, right, :, 0] = far_y
    pairs[:, :, right, :, 1] = W + 30.25
    offsets = pairs.reshape(offsets.shape).contiguous()
    x[:, 0, W - 1, 0::2] = float("inf")
    x[:, H - 1, W - 1, 1::2] = float("nan")
    got = deform_conv_sample(x, offsets, mask, stride)
    want = deform_conv_sample_plain(x, offsets, mask, stride)
    torch.cuda.synchronize()
    assert bool(want.isnan().any()) and bool(torch.isfinite(want).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,B,S,C", [("below_one_tile", 1, 3, 256), ("ragged", 3, 337, 256),
                                        ("zero_channel", 2, 1001, 128), ("narrow", 1, 4099, 64),
                                        ("narrow", 2, 777, 32), ("one_chunk", 1, 5000, 8),
                                        ("encoder", 4, 22323, 256)])
def test_msda_q8_quantize_exact(cuda, dtype, case, B, S, C):
    """The one-launch quantisation (a persistent cooperative grid) exactly
    equal to the plain quantisation: fewer rows than one row tile of a
    block, rows that are no multiple of the blocks' slices, a channel of
    zeros (scale 1e-20, table 0), C / 8 chunks from 1 to 32; two calls give
    the same bits, one counted launch each."""
    from salience_detr_torch.ops.deform_attn import q8_quantize, q8_quantize_plain

    g = torch.Generator().manual_seed(S + C)
    value = (torch.randn(B, S, C, generator=g) * 3).to(cuda, dtype)
    if case == "zero_channel":
        value[..., 5] = 0
    before = native.LAUNCHES["msda_q8_quantize"]
    first, second = q8_quantize(value), q8_quantize(value)
    want_table, want_scale = q8_quantize_plain(value)
    torch.cuda.synchronize()
    assert native.LAUNCHES["msda_q8_quantize"] == before + 2
    assert torch.equal(first[0], want_table) and torch.equal(first[1], want_scale)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    if case == "zero_channel":
        assert float(first[1][5]) == float(torch.tensor(1e-20)) and not bool(first[0][..., 5].any())


# ---------------------------------------------------------------- the DCN layer: fused 16-bit forward


def dcn_layer_inputs(device, dtype, stride, C, F, B=2, H=13, W=17, seed=20):
    """dcn_inputs and a kernel (9, C, F) ~ N(0, 1 / (9 C)) in float32."""
    x, offsets, mask = dcn_inputs(device, dtype, stride, C, B, H, W, seed)
    g = torch.Generator().manual_seed(seed + 1)
    weight = (torch.randn(9, C, F, generator=g) / (9 * C) ** 0.5).to(device)
    return x, offsets, mask, weight


def fused_errors(got, x, offsets, mask, weight, stride):
    """The fused output against deform_conv2d_plain on the card (the same
    columns, cuBLAS's product in x's dtype) and both against the float32
    product of the same columns: (max |fused - plain|, max |fused - ref|,
    max |plain - ref|, max |ref|)."""
    from salience_detr_torch.ops.deform_conv import deform_conv2d_plain, deform_conv_sample_plain

    plain = deform_conv2d_plain(x, offsets, mask, weight, stride)
    cols = deform_conv_sample_plain(x, offsets, mask, stride)
    w = weight.reshape(-1, weight.shape[-1]).to(x.dtype).float()
    ref = torch.matmul(cols.float().reshape(-1, w.shape[0]), w).reshape(got.shape)
    return (float((got.float() - plain.float()).abs().max()), float((got.float() - ref).abs().max()),
            float((plain.float() - ref).abs().max()), float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("C,F", [(32, 32), (64, 64), (128, 128), (256, 256), (64, 200), (32, 8), (512, 512),
                                 (64, 320), (32, 12)])
def test_deform_conv_fused_matches_plain(cuda, dtype, stride, C, F):
    """The fused kernel at any F a multiple of 8, and the layer's route.

    The kernel (one launch, no columns launch): M = 2 * 13 * 17 (stride 1)
    or 2 * 7 * 9 pixels, not a multiple of the 128- or 64-pixel tile, and F
    = 200, 8 or 320 not a multiple of the 128- or 256-channel tile; F = 512
    takes two column tiles; std-2 px offsets put taps outside the image.  The output within one ulp of x's dtype (2^-7 bf16,
    2^-10 f16, relative) plus 1e-3 of the largest output of the plain layer,
    and no farther from the float32 product of the same columns than the
    plain layer's own rounding allows (the final rounding of both, half an
    ulp, plus the sums' orders).  F = 12 is no multiple of 8: the kernel
    raises ValueError.

    The route (``deform_conv2d``): F <= 128 and a multiple of 8 the fused
    kernel alone, its output equal to the kernel's; any other F the columns
    kernel and torch.matmul, equal to deform_conv2d_plain on the card."""
    from salience_detr_torch.ops.deform_conv import (
        _fused_cuda,
        deform_conv2d,
        deform_conv2d_plain,
        uses_fused_kernel,
    )

    x, offsets, mask, weight = dcn_layer_inputs(cuda, dtype, stride, C, F)
    fused = uses_fused_kernel(dtype, F)
    assert fused == (F <= 128 and F % 8 == 0)
    before = dict(native.LAUNCHES)
    route = deform_conv2d(x, offsets, mask, weight, stride)
    torch.cuda.synchronize()
    assert native.LAUNCHES["deform_conv_fused"] == before["deform_conv_fused"] + fused
    assert native.LAUNCHES["deform_conv"] == before["deform_conv"] + (not fused)
    assert route.dtype == dtype and route.shape == (*offsets.shape[:3], F)
    plain = deform_conv2d_plain(x, offsets, mask, weight, stride)
    if F % 8:
        with pytest.raises(ValueError):
            _fused_cuda(x, offsets, mask, weight, stride)
        assert torch.equal(route, plain)
        return
    before = dict(native.LAUNCHES)
    got = _fused_cuda(x, offsets, mask, weight, stride)
    torch.cuda.synchronize()
    assert native.LAUNCHES["deform_conv_fused"] == before["deform_conv_fused"] + 1
    assert native.LAUNCHES["deform_conv"] == before["deform_conv"]
    assert torch.equal(route, got if fused else plain)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    err = (got.float() - plain.float()).abs()
    assert bool((err <= ulp * plain.float().abs() + 1e-3 * float(plain.float().abs().max())).all())
    _, to_ref, plain_to_ref, top = fused_errors(got, x, offsets, mask, weight, stride)
    assert to_ref <= max(plain_to_ref, ulp / 2 * top) * 1.01 + 1e-6
    out = _fused_cuda(x, torch.full_like(offsets, -500.0), mask, weight, stride)
    assert not bool(out.any())  # every tap outside the image


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv2d_16bit_backward(cuda, dtype, stride):
    """The backward of the fused route: one columns launch (the recompute)
    and one gather launch; gradients against autograd of
    deform_conv2d_plain (the MSDA backward's 16-bit tolerances for d_x, the
    products' bf16/f16 rounding for the rest: max |d| <= 1e-2 max |ref|)."""
    from salience_detr_torch.ops.deform_conv import deform_conv2d, deform_conv2d_plain

    x, offsets, mask, weight = dcn_layer_inputs(cuda, dtype, stride, 64, 96, H=15, W=19)
    inputs = [t.clone().requires_grad_() for t in (x, offsets, mask, weight)]
    out = deform_conv2d(*inputs, stride)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(22)).to(cuda, dtype)
    before = dict(native.LAUNCHES)
    out.backward(d_out)
    torch.cuda.synchronize()
    assert native.LAUNCHES["deform_conv"] == before["deform_conv"] + 1
    assert native.LAUNCHES["deform_conv_backward"] == before["deform_conv_backward"] + 1
    assert native.LAUNCHES["deform_conv_fused"] == before["deform_conv_fused"]
    auto = [t.clone().requires_grad_() for t in (x, offsets, mask, weight)]
    deform_conv2d_plain(*auto, stride).backward(d_out)
    for name, a, b in zip(("d_x", "d_offsets", "d_mask", "d_weight"), inputs, auto):
        assert a.grad.dtype == b.grad.dtype, name
        err = float((a.grad.float() - b.grad.float()).abs().max())
        assert err <= 1e-2 * float(b.grad.float().abs().max()) + 1e-5, (name, err)


@pytest.mark.gpu
def test_deform_conv2d_float32_route(cuda):
    """float32 x: the columns kernel and torch.matmul (TF32 off), no fused
    launch; forward and gradients against the plain layer at the f32
    tolerances."""
    from salience_detr_torch.ops.deform_conv import deform_conv2d, deform_conv2d_plain

    x, offsets, mask, weight = dcn_layer_inputs(cuda, torch.float32, 2, 64, 64)
    inputs = [t.clone().requires_grad_() for t in (x, offsets, mask, weight)]
    before = dict(native.LAUNCHES)
    out = deform_conv2d(*inputs, 2)
    torch.cuda.synchronize()
    assert native.LAUNCHES["deform_conv"] == before["deform_conv"] + 1
    assert native.LAUNCHES["deform_conv_fused"] == before["deform_conv_fused"]
    auto = [t.clone().requires_grad_() for t in (x, offsets, mask, weight)]
    want = deform_conv2d_plain(*auto, 2)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(23)).to(cuda)
    out.backward(d_out)
    want.backward(d_out)
    assert native.LAUNCHES["deform_conv"] == before["deform_conv"] + 2
    assert native.LAUNCHES["deform_conv_backward"] == before["deform_conv_backward"] + 1
    for name, a, b in zip(("d_x", "d_offsets", "d_mask", "d_weight"), inputs, auto):
        err = float((a.grad - b.grad).abs().max())
        assert err <= 1e-5 * float(b.grad.abs().max()) + 1e-6, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("stride,C", [(1, 32), (2, 128), (1, 256)])
def test_deform_conv_kernels_float16(cuda, stride, C):
    """The columns kernel and the gather backward in float16: the columns
    bit-equal to the plain version's (one rounding of the same f32 sums), the
    gradients within the 16-bit tolerances of the plain backward and
    autograd of the plain forward."""
    from salience_detr_torch.ops.deform_conv import (
        _backward_cuda,
        deform_conv_sample,
        deform_conv_sample_plain,
    )

    x, offsets, mask = dcn_inputs(cuda, torch.float16, stride, C, H=19, W=23)
    got = deform_conv_sample(x, offsets, mask, stride)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16 and torch.equal(got, deform_conv_sample_plain(x, offsets, mask, stride))
    d_cols = torch.randn(got.shape, generator=torch.Generator().manual_seed(24)).to(cuda, torch.float16)
    grads = _backward_cuda(x, offsets, mask, stride, d_cols)
    torch.cuda.synchronize()
    assert grads[0].dtype == torch.float16
    assert_dcn_grads_close(grads, dcn_backward_refs(x, offsets, mask, stride, d_cols))


@pytest.mark.gpu
def test_tiny_r50_dcn_train_step_in_float16(cuda):
    """A small DCN model (stages 2-4 deformable, F = 128, 256, 512) trains
    one step under float16 autocast through the DCN kernels: finite losses;
    the two F = 128 layers one fused launch each, the four others one
    columns launch each, every layer one columns launch (the recompute) and
    one gather launch in backward; every DCN parameter with a nonzero
    gradient moves."""
    from salience_detr_torch.models.bricks.deform_conv import DeformConv2dPack
    from salience_detr_torch.models.factory import SalienceDETRConfig
    from salience_detr_torch.train import TRAIN_CONFIG, Trainer
    from salience_detr_torch.utils.config import Config

    cfg = SalienceDETRConfig(
        backbone="resnet18", embed_dim=32, num_classes=5, num_queries=24, num_encoder_layers=2,
        num_decoder_layers=2, num_heads=4, dim_feedforward=64, topk_sa=12, layer_filter_ratio=(1.0, 0.5),
        max_num_embedding=16, encoder_sampling_groups=1, min_size=96, max_size=128,
        select_box_nums_for_evaluation=20, denoising_nums=4, stage_with_dcn=(False, True, True, True),
        dtype=torch.float16)
    tc = Config(str(TRAIN_CONFIG), max_gt=6, train_canvas=(96, 128)).to_dict()
    trainer = Trainer(cfg, "cuda", seed=6, steps_per_epoch=1, train_cfg=tc)
    layers = [m for m in trainer.model.modules() if isinstance(m, DeformConv2dPack)]
    g = torch.Generator().manual_seed(20)
    with torch.no_grad():  # move the taps off the pixel grid (zero offset convs at init)
        for m in layers:
            for p in (m.conv_offset.weight, m.conv_mask.weight):
                p.copy_(torch.randn(p.shape, generator=g).to(p.device) * 0.05)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if ".conv2." in n}
    batch = next(trainer.batches(1, seed=6, counts=(3, 1)))
    counts = dict(native.LAUNCHES)
    metrics = trainer.step(batch, trainer.generator)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values()), metrics
    n = len(layers)
    assert n == 6 and sorted(m.deform_conv2d.weight.shape[0] for m in layers) == [128, 128, 256, 256, 512, 512]
    want = {"deform_conv_fused": 2, "deform_conv": (n - 2) + n, "deform_conv_backward": n}
    assert {key: native.LAUNCHES[key] - counts[key] for key in want} == want
    params = dict(trainer.model.named_parameters())
    dcn = [k for k in before
           if k.startswith("backbone.") and any(s in k for s in ("conv_offset", "conv_mask", "deform_conv2d"))]
    assert len(dcn) == 5 * n
    for k in dcn:
        if params[k].grad is not None and float(params[k].grad.abs().max()) > 0:
            assert not torch.equal(params[k].detach(), before[k]), k
    assert all(params[k].grad is not None and float(params[k].grad.abs().max()) > 0
               for k in dcn if "deform_conv2d" in k)
