"""Numpy mirrors of the two thread-block-cluster designs, held against the JAX
package and the port's plain versions on the CPU.

K9, the NMS keep mask (``salience_detr_torch/csrc/nms_keep.cu``): the blocks
of a cluster share out the conflict bitmask's rows by 32-rank window (round j
of C windows to blocks 0 .. C-1 when j is even, C-1 .. 0 when it is odd) and
store them where ``nms_keep_plan`` places them: in the walking block's
bitmask ("local"), in each filling block's own windows ("remote") or in a
global scratch buffer ("global"); storage starts
as garbage, so a word the kernel neither writes nor reads stays wrong.  The
walk reads the window's rows through the same mapping as the kernel, over a
removed-mask of one word per 32 ranks.  The keep mask must equal the JAX
``nms_keep_mask`` (vmapped, as ``tests/test_nms.py`` and the JAX
``PostProcess`` run it) and ``nms_keep_mask_plain`` exactly; the IoU test
is rounded as ``iou_above`` rounds it (float32 operations, NaN propagated).

K5, the cluster-staged gather-sum (``salience_detr_torch/tools/
gather_cluster/gather_sum.cu``): the tail's rows are copied into the blocks'
stages as the kernel's TMA boxes lay them out, a row s >= S - T is read from
its owner's stage at ``owner_and_row``, and the sums follow the kernel's
per-lane-slot f32 order (slot g % 8 sums its rows in g order, then the
butterfly ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7))), rounded once
to bf16.  It must be within one bf16 ulp (the ``stage_close`` tolerance of
``tests/test_torch_port_kernels.py``) of ``gather_sum_plain`` and of the JAX
``gather_c`` Pallas kernel (interpreted, the body of
``tests/test_torch_port_msda_stages.py``'s P1 test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from salience_detr_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from salience_detr_torch.ops import msda_stages as st
from salience_detr_torch.ops.nms import (
    SMEM_OPTIN_BYTES,
    nms_keep_mask_plain,
    nms_keep_plan,
    nms_keep_smem_bytes,
)
from salience_detr_torch.tools import gather_cluster as gc
from tests.test_torch_port_kernels import NMS_KEEP_CASES, random_boxes
from tests.torch_port_common import two_torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

GARBAGE = np.uint32(0xA5A5A5A5)


# ---------------------------------------------------------------- K9


def iou_above(a, b, thr):
    """(N, 4) float32 boxes -> (N, N) bool: iou(a[i], b[j]) > thr in the
    kernel's order of float32 operations; a zero intersection tests 0 > thr
    unless the union is NaN."""
    with np.errstate(invalid="ignore", divide="ignore"):
        area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        w = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]),
                       np.float32(0))
        h = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]),
                       np.float32(0))
        inter = w * h
        union = np.maximum(area_a[:, None] + area_b[None, :] - inter, np.float32(1e-12))
        zero = inter == 0
        return np.where(zero, ~np.isnan(union) & (np.float32(0) > np.float32(thr)),
                        inter / np.where(zero, np.float32(1), union) > np.float32(thr))


def conflict_words(boxes, thr):
    """(N, W) uint32: row i's word w holds bit b iff 32w + b > i suppresses."""
    N = boxes.shape[0]
    W = -(-N // 32)
    hit = iou_above(boxes, boxes, thr) & (np.arange(N)[None, :] > np.arange(N)[:, None])
    hit = np.pad(hit, ((0, 0), (0, 32 * W - N))).reshape(N, W, 32)
    return (hit.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def window_owner(k, C):
    """The block that fills window k (``window_owner`` in the kernel)."""
    return C - 1 - k % C if (k // C) % 2 else k % C


def fill(boxes, thr, rows, C):
    """The cluster's fill: block r stores the rows of its windows (words from
    the diagonal's on) where ``rows`` places them.  Returns
    window_rows(k) -> the (32, W) words the walk reads for window k, and the
    words each block computed."""
    N = boxes.shape[0]
    W = -(-N // 32)
    words = conflict_words(boxes, thr)
    per_block = -(-W // C)
    if rows == "remote":
        store = [np.full((32 * per_block, W), GARBAGE, np.uint32) for _ in range(C)]
    else:  # local: block 0's bitmask; global: the scratch buffer
        store = np.full((32 * W, W), GARBAGE, np.uint32)
    work = np.zeros(C, np.int64)
    for rank in range(C):
        for kk in range(per_block):
            k = kk * C + (C - 1 - rank if kk % 2 else rank)
            if k >= W:
                continue
            for b in range(32):
                i = 32 * k + b
                if i >= N:
                    break
                dst = store[rank][32 * kk + b] if rows == "remote" else store[i]
                dst[k:] = words[i, k:]
                work[rank] += W - k

    def window_rows(k):
        if rows == "remote":
            return store[window_owner(k, C)][32 * (k // C):32 * (k // C) + 32]
        return store[32 * k:32 * k + 32]

    return window_rows, work


def walk(window_rows, N):
    """The walking warp: window by window, the decisions from the window's
    own row words, then the kept ranks' rows ORed into the later words."""
    W = -(-N // 32)
    removed = np.zeros(W, np.uint32)
    keep = np.zeros(N, bool)
    for k in range(W):
        rows_k = window_rows(k)
        n = min(32, N - 32 * k)
        own = [int(rows_k[b, k]) if b < n else 0 for b in range(32)]
        cur, kept = int(removed[k]), 0
        for b in range(32):
            if not cur >> b & 1:
                kept |= 1 << b
                cur |= own[b]
        if n < 32:
            kept &= (1 << n) - 1
        chosen = [b for b in range(n) if kept >> b & 1]
        if k + 1 < W and chosen:
            removed[k + 1:] |= np.bitwise_or.reduce(rows_k[chosen, k + 1:], axis=0)
        keep[32 * k:32 * k + n] = [bool(kept >> b & 1) for b in range(n)]
    return keep


def cluster_keep(boxes, thr, rows, C):
    return np.stack([walk(fill(b, thr, rows, C)[0], b.shape[0]) for b in boxes])


@functools.lru_cache(maxsize=None)
def reference(name):
    """(boxes, thr, JAX keep mask) of a named case."""
    if name in NMS_KEEP_CASES:
        boxes, thr = NMS_KEEP_CASES[name]
    else:
        kind, n = name.split("_")
        rng = np.random.default_rng(int(n))
        n = int(n)
        B = 1 if n > 1024 else 2
        boxes = random_boxes(rng, B, n, extent=(400.0 if kind == "spread" else 60.0) * max(n, 64) / 1024)
        thr = 0.5 if kind == "spread" else 0.7
        if kind == "nan":
            boxes[0, rng.integers(0, n, max(1, n // 20))] = np.nan
            boxes[-1, :: max(1, n // 7), 1] = np.nan
            thr = 0.5
        boxes[-1, n // 2:n // 2 + 5] = boxes[-1, n // 2]  # identical boxes
    want = np.asarray(jax.vmap(lambda b: jax_nms_keep_mask(b, thr))(jnp.asarray(boxes)))
    return boxes, thr, want


def placements(N):
    """The placements the kernel can take at N, at its cluster size."""
    C = nms_keep_plan(N)[1]
    return [r for r in ("local", "remote", "global")
            if r == "global" or nms_keep_smem_bytes(r, N, C) <= SMEM_OPTIN_BYTES]


@pytest.mark.parametrize("rows", ["local", "remote", "global"])
@pytest.mark.parametrize("name", sorted(NMS_KEEP_CASES))
def test_cluster_keep_mirror_on_cases(name, rows):
    boxes, thr, want = reference(name)
    C = nms_keep_plan(boxes.shape[1])[1]
    got = cluster_keep(boxes, thr, rows, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nms_keep_mask_plain(torch.from_numpy(boxes), thr).numpy(), want)


RANDOM_KEEP = [(f"{kind}_{n}", rows) for n in (1, 31, 32, 33, 300, 1023, 1024, 1025, 1400, 2048)
               for kind in (("spread", "crowded", "nan") if n <= 1024 else ("crowded",))
               for rows in placements(n)]


@pytest.mark.parametrize("name,rows", RANDOM_KEEP)
def test_cluster_keep_mirror_on_random_boxes(name, rows):
    """Seeded spread (thr 0.5), crowded (0.7) and partly NaN (0.5) boxes,
    five identical in the last image, at every placement the kernel can take
    there and its cluster size; crowded only past 1024 boxes (one image)."""
    boxes, thr, want = reference(name)
    got = cluster_keep(boxes, thr, rows, nms_keep_plan(boxes.shape[1])[1])
    np.testing.assert_array_equal(got, want)
    if boxes.shape[1] <= 1024:
        np.testing.assert_array_equal(nms_keep_mask_plain(torch.from_numpy(boxes), thr).numpy(), want)


@pytest.mark.parametrize("C", [1, 3, 8, 16])
def test_cluster_keep_mirror_any_cluster_size(C):
    """The partition is right for any cluster size, also one that leaves
    blocks without a window (C > W) or windows uneven over the blocks."""
    boxes, thr, want = reference("crowded_300")
    for rows in ("local", "remote", "global"):
        np.testing.assert_array_equal(cluster_keep(boxes, thr, rows, C), want)


@pytest.mark.parametrize("N,C", [(2048, 16), (2048, 8), (1400, 16), (4096, 16)])
def test_window_interleave_balances_the_triangle(N, C):
    """The back-and-forth rounds pair each block's long rows of the triangle
    with short ones: with whole pairs of rounds (2048 and 4096 boxes) every
    block computes within 6% of the mean number of words, and at 1400 boxes
    (2.75 rounds) the busiest block is still less far above the mean than
    with windows r, r + C, ....  The mirror's fill counts the same words."""
    W = -(-N // 32)
    words = [min(32, N - 32 * k) * (W - k) for k in range(W)]
    work = np.bincount([window_owner(k, C) for k in range(W)], weights=words, minlength=C)
    plain = np.bincount(np.arange(W) % C, weights=words, minlength=C)
    assert plain.max() / plain.mean() > work.max() / work.mean()
    if W % (2 * C) == 0:
        assert work.max() / work.mean() < 1.06 and work.min() / work.mean() > 0.94
    if N == 1400:
        boxes, thr, _ = reference("crowded_1400")
        np.testing.assert_array_equal(fill(boxes[0], thr, "remote", C)[1], work)


def test_keep_plan_places_the_rows():
    """Local while 20N + 4W + 4NW bytes fit the 227 KB a block can opt in to
    (N up to 1280), remote while a block's ceil(W / C) windows fit beside the
    boxes (up to 4128 boxes at 16 blocks, 3200 at 8), global past that; the
    cluster is one block a window at most."""
    assert nms_keep_plan(300) == ("local", 10)
    assert nms_keep_plan(1280) == ("local", 16) and nms_keep_plan(1281) == ("remote", 16)
    assert nms_keep_plan(4128) == ("remote", 16) and nms_keep_plan(4129) == ("global", 16)
    assert nms_keep_plan(3200, cluster=8) == ("remote", 8) and nms_keep_plan(3201, cluster=8)[0] == "global"
    assert nms_keep_plan(1) == ("local", 1) and nms_keep_plan(33) == ("local", 2)
    for N in (1, 300, 1280, 4096):
        W = -(-N // 32)
        assert nms_keep_smem_bytes("local", N, 16) == 16 * N + 4 * N + 4 * W + 4 * N * W
        assert nms_keep_smem_bytes("remote", N, 16) == 20 * N + 4 * W + 4 * 32 * -(-W // 16) * W
        assert nms_keep_smem_bytes("global", N, 16) == 4 * W


# ---------------------------------------------------------------- K5

GS_LEVELS = [(6, 9), (3, 5), (2, 3), (2, 2)]
GS_S = sum(h * w for h, w in GS_LEVELS)
GS_B, GS_H, GS_Q, GS_D = 2, 8, 20, 32


def bf16_values(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16().float().numpy()


def stages_of(value, T, C):
    """Each block's stage as the kernel's TMA boxes fill it: rows S - T +
    rank * rows onwards of the flattened (B*S, H*D) view, whole boxes, zero
    past the tensor; (B, H, C, alloc, D)."""
    B, S, H, D = value.shape
    rows, box, alloc = gc.gather_stage(T, C)
    flat = np.concatenate([value.reshape(B * S, H * D), np.zeros((alloc * C + S, H * D), np.float32)])
    out = np.zeros((B, H, C, max(alloc, 1), D), np.float32)
    for b in range(B):
        for r in range(C):
            if rows and r * rows < T:
                start = b * S + S - T + r * rows
                out[b, :, r, :alloc] = flat[start:start + alloc].reshape(alloc, H, D).transpose(1, 0, 2)
    return out


def staged_mirror(value, idx, T, C):
    """The cluster-staged kernel's sums: (B, H, Q, D) float32 before the bf16
    rounding, and the rows it reads from outside the stages."""
    B, S, H, D = value.shape
    G = idx.shape[-1]
    rows = gc.gather_stage(T, C)[0]
    stage = stages_of(value, T, C)
    slots = np.zeros((8, B, H, idx.shape[2], D), np.float32)
    bi, hi = np.meshgrid(np.arange(B), np.arange(H), indexing="ij")
    from_l2 = 0
    for g in range(G):
        s = idx[..., g]
        valid = (s >= 0) & (s < S)
        t = s - (S - T)
        staged = valid & (t >= 0)
        from_l2 += int((valid & ~staged).sum())
        sc = np.where(valid, s, 0)
        row = value[bi[..., None], sc, hi[..., None]]  # (B, H, Q, D)
        if staged.any():
            owner, off = gc.owner_and_row(np.where(staged, t, 0).astype(np.int64), max(rows, 1))
            srow = stage[bi[..., None], hi[..., None], owner, off]
            assert np.array_equal(srow[staged], row[staged])
            row = np.where(staged[..., None], srow, row)
        slots[g % 8] = np.where(valid[..., None], slots[g % 8] + row, slots[g % 8])
    a = slots
    return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7])), from_l2


def gather_indices(rng, pattern, T, G=64):
    """(B, H, Q, G) int32: all inside the staged tail, all outside it, or
    both with a few indices outside [0, S)."""
    lo, hi = {"inside": (GS_S - max(T, 1), GS_S), "outside": (0, max(GS_S - T, 1)), "mixed": (0, GS_S)}[pattern]
    idx = rng.integers(lo, hi, (GS_B, GS_H, GS_Q, G)).astype(np.int32)
    if pattern == "mixed":
        idx[0, 0, 0, :3] = [-1, GS_S, 1 << 30]
    return idx


@functools.lru_cache(maxsize=None)
def jax_gather_c(seed, pattern, T):
    """value, idx and the JAX gather_c (Pallas kernel interpreted, QT=8, Q
    padded by index 0) for in-range indices; out-of-range indices are given
    index 0 over a zero row 0, as the kernel's skipping gives."""
    rng = np.random.default_rng(seed)
    value = bf16_values(rng, (GS_B, GS_S, GS_H, GS_D))
    value[:, 0] = 0
    idx = gather_indices(rng, pattern, T)
    clean = np.where((idx >= 0) & (idx < GS_S), idx, 0)
    QT, G = 8, idx.shape[-1]
    qpad = -(-GS_Q // QT) * QT

    def kernel(v_ref, i_ref, o_ref):
        v = v_ref[0, 0]
        ix = i_ref[0, 0]
        o_ref[0, 0] = jnp.take(v, ix.reshape(-1), axis=0).reshape(QT, G, GS_D).sum(axis=1)

    want = pl.pallas_call(
        kernel,
        grid=(GS_B, GS_H, qpad // QT),
        in_specs=[
            pl.BlockSpec((1, 1, GS_S, GS_D), lambda b, h, q: (b, h, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, QT, G), lambda b, h, q: (b, h, q, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 1, QT, GS_D), lambda b, h, q: (b, h, q, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((GS_B, GS_H, qpad, GS_D), jnp.bfloat16),
        interpret=True,
    )(jnp.swapaxes(jnp.asarray(value).astype(jnp.bfloat16), 1, 2),
      jnp.asarray(np.pad(clean, ((0, 0), (0, 0), (0, qpad - GS_Q), (0, 0)))))
    return value, idx, clean, np.asarray(want.astype(jnp.float32))[:, :, :GS_Q]


def close_bf16(got, want):
    """Within one bf16 ulp of the larger magnitude, plus 1e-6 (both sides
    round one f32 sum once)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    assert float(np.max(np.abs(got - want) - bound)) <= 0


@pytest.mark.parametrize("pattern", ["inside", "outside", "mixed"])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [0, 25, GS_S])
def test_staged_gather_mirror(T, C, pattern):
    """The staged/unstaged split at T = 0, a tail in between (25 of 97 rows:
    levels 2-3 and part of 1) and T = S, over 1-8 blocks, with indices all in
    the tail, all outside it, or both with out-of-range ones: within one bf16
    ulp of gather_sum_plain and of the JAX gather_c, and reading from L2
    exactly the rows outside the tail."""
    value, idx, clean, want_jax = jax_gather_c(20, pattern, T)
    got, from_l2 = staged_mirror(value, idx, T, C)
    got = torch.from_numpy(got).bfloat16()
    plain = st.gather_sum_plain(torch.from_numpy(value).bfloat16(), torch.from_numpy(clean))
    close_bf16(got.float(), plain.float())
    close_bf16(got.float(), want_jax)
    in_range = (idx >= 0) & (idx < GS_S)
    assert from_l2 == int((in_range & (idx < GS_S - T)).sum())
    if pattern == "inside" and T:
        assert from_l2 == 0


@pytest.mark.parametrize("G", [5, 70])
def test_staged_gather_mirror_ragged(G):
    """Ragged G (one partial chunk of 64; a full one and a partial one) with
    out-of-range indices, against gather_sum_plain."""
    rng = np.random.default_rng(21)
    value = bf16_values(rng, (GS_B, GS_S, GS_H, GS_D))
    value[:, 0] = 0
    idx = rng.integers(-3, GS_S + 3, (GS_B, GS_H, GS_Q, G)).astype(np.int32)
    clean = np.where((idx >= 0) & (idx < GS_S), idx, 0)
    plain = st.gather_sum_plain(torch.from_numpy(value).bfloat16(), torch.from_numpy(clean)).float()
    for T, C in ((0, 1), (40, 3), (GS_S, 8)):
        got, _ = staged_mirror(value, idx, T, C)
        close_bf16(torch.from_numpy(got).bfloat16().float(), plain)


def test_owner_division_is_exact():
    """(t * ceil(2^32 / rows)) >> 32 == t // rows for every tail row the
    kernel can be given: rows a block up to 3,584, t below 8 blocks' rows."""
    for rows in range(1, gc.BLOCK_ROWS + 1):
        t = np.arange(gc.MAX_CLUSTER * rows, dtype=np.uint64)
        owner = (t * np.uint64(gc.magic(rows))) >> np.uint64(32)
        np.testing.assert_array_equal(owner, t // np.uint64(rows))


def test_gather_stage_plan():
    """Whole TMA boxes of an even height, 128-byte aligned; a block's whole
    budget is 3,584 rows within the 227 KB; the plan fills 132 SMs."""
    assert gc.gather_stage(0, 1) == (0, 0, 0)
    assert gc.gather_stage(1323, 1) == (1323, 256, 1536)
    assert gc.gather_stage(5523, 4) == (1381, 256, 1536)
    assert gc.gather_stage(25, 8) == (4, 4, 4) and gc.gather_stage(3, 2) == (2, 2, 2)
    for T, C in ((1323, 1), (5523, 2), (22323, 8), (7, 3)):
        rows, box, alloc = gc.gather_stage(T, C)
        assert box % 2 == 0 and alloc % box == 0 and rows * C >= T and alloc >= rows
    assert gc.gather_sum_smem_bytes(gc.BLOCK_ROWS, 1) <= gc.SMEM_OPTIN_BYTES
    assert gc.gather_sum_smem_bytes(gc.BLOCK_ROWS + 1, 1) > gc.SMEM_OPTIN_BYTES
    assert gc.gather_sum_plan(4, 22323, 8, 11403) == (3584, 1, 4)
    assert gc.gather_sum_plan(4, 22323, 8, 11403, cluster=8) == (22323, 8, 1)
