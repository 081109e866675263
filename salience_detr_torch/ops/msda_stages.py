"""Stage kernels of the staged MSDA shootout, and the index and weight
preparation that feeds them (port of the Pallas kernels and helpers of
tools/bench_gather.py, bench_msda2.py, bench_msda3.py and bench_msda5.py).

The shootout splits head-shared multi-scale deformable attention (one
sampling location per (b, q, l, p), shared by the H heads) into stages: a
row gather of the bilinear corners in one of three layouts (quad-packed,
corner-blocked, point-major), then a streaming kernel that collapses the
gathered rows.  The fused kernel K1 (``ops/deform_attn.py``) does all of it in
one pass; these stages exist to measure the decomposition.

Preparation, each with the JAX tool's layout at its boundary and
``x = loc * w - 0.5`` rounded twice, as K1 computes it:
:func:`make_inputs`, :func:`corners_flat`, :func:`corners_pmajor`,
:func:`build_quad`, :func:`quad_base_and_weights`, :func:`corner_blocked`.

Kernels, each with its plain PyTorch version (the kernel's spec, f32
accumulation) and a wrapper that runs the plain version on a CPU tensor and
launches the kernel on a CUDA tensor, or raises:

* K5 :func:`gather_sum` (``csrc/gather_sum.cu``): unweighted sums of gathered
  per-head rows (bench_gather.py ``gather_c``);
* K6 :func:`weighted_reduce` (``csrc/weighted_reduce.cu``): the per-(sub-row,
  head) weighted reduce (bench_msda2.py ``pallas_reduce``, bench_msda3.py
  ``make_reduce``);
* K7 :func:`corner_collapse_blocked` and K8 :func:`corner_collapse_packed`
  (``csrc/corner_collapse.cu``): the bilinear corner collapse of
  corner-blocked rows (bench_msda2.py ``_pl_blk_sampled``) and of packed rows
  (``_pl_nat_sampled``; bench_msda5.py ``kern`` and ``kern2d``).

The kernels read bf16 rows; none has a backward (the shootout measures
forwards only).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from salience_detr_torch import native

Shapes = Sequence[Tuple[int, int]]


def make_inputs(
    Q: int,
    spatial_shapes: Shapes,
    B: int = 4,
    generator: Optional[torch.Generator] = None,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shootout's random inputs (bench_msda2.py ``make_inputs``, C=256,
    H=8, P=4): value (B, S, C) bf16 from a normal, locations (B, Q, L, P, 2)
    uniform in [0.02, 0.98], attention (B, Q, H, L, P) uniform, normalised
    over (L, P)."""
    S, L = sum(h * w for h, w in spatial_shapes), len(spatial_shapes)
    C, H, P = 256, 8, 4
    value = torch.randn(B, S, C, generator=generator, device=device).to(torch.bfloat16)
    locs = torch.rand(B, Q, L, P, 2, generator=generator, device=device) * 0.96 + 0.02
    w = torch.rand(B, Q, H, L, P, generator=generator, device=device)
    return value, locs, w / w.sum((-2, -1), keepdim=True)


def _level_coords(loc: torch.Tensor, h: int, w: int):
    """loc (..., 2) in [0, 1] -> integer corner (x0, y0) and fractions
    (fx, fy); ``loc * w - 0.5`` is two roundings (no fused multiply-add)."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    return x0.long(), y0.long(), x - x0, y - y0


def _corner_terms(
    locs: torch.Tensor, spatial_shapes: Shapes
) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Per level, the four corners in order iy * 2 + jx as (flat token index
    within the batch element, zero-padded bilinear weight), each (B, Q, P).
    A corner outside its level is clamped into it with weight 0."""
    levels, start = [], 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x0, y0, fx, fy = _level_coords(locs[:, :, lvl], h, w)
        corners = []
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                cx, cy = x0 + dx, y0 + dy
                valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
                index = start + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
                corners.append((index.to(torch.int32), torch.where(valid, wx * wy, 0.0)))
        levels.append(corners)
        start += h * w
    return levels


def corners_flat(locs: torch.Tensor, spatial_shapes: Shapes) -> Tuple[torch.Tensor, torch.Tensor]:
    """locs (B, Q, L, P, 2) -> corner indices (int32) and bilinear weights
    (f32), each (B, Q, L*4, P): item l*4 + corner, then the points
    (bench_msda2.py ``corners_flat``)."""
    terms = [c for level in _corner_terms(locs, spatial_shapes) for c in level]
    return torch.stack([i for i, _ in terms], 2), torch.stack([w for _, w in terms], 2)


def corners_pmajor(locs: torch.Tensor, spatial_shapes: Shapes) -> Tuple[torch.Tensor, torch.Tensor]:
    """locs (B, Q, L, P, 2) -> corner indices (int32) and bilinear weights
    (f32), each (B, Q, L, P, 4): level, point, then corner
    (bench_msda2.py ``corners_pmajor``)."""
    levels = _corner_terms(locs, spatial_shapes)
    idx = torch.stack([torch.stack([i for i, _ in lv], -1) for lv in levels], 2)
    cw = torch.stack([torch.stack([w for _, w in lv], -1) for lv in levels], 2)
    return idx, cw


def build_quad(value: torch.Tensor, spatial_shapes: Shapes) -> torch.Tensor:
    """(B, S, C) -> (B, S, 4C): row s holds [v[s], v[s+1], v[s+w], v[s+w+1]],
    w its level's width (bench_msda2.py ``build_quad``).  The shifts cross
    level boundaries; those corners get weight 0 from
    :func:`quad_base_and_weights`."""
    right = torch.roll(value, -1, 1)
    segs, start = [], 0
    for h, w in spatial_shapes:
        segs.append(torch.roll(value[:, start:start + h * w], -w, 1))
        start += h * w
    down = torch.cat(segs, 1)
    return torch.cat([value, right, down, torch.roll(down, -1, 1)], -1)


def quad_base_and_weights(
    locs: torch.Tensor, attn: torch.Tensor, spatial_shapes: Shapes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """locs (B, Q, L, P, 2), attn (B, Q, H, L, P) -> base (B, Q, L, P) int32
    and weights (B, Q, L, P, 4, H) f32, corner order iy * 2 + jx
    (bench_msda2.py ``quad_base_and_weights``).

    The base corner is clipped into [0, w-2] x [0, h-2], so the 2x2 quad lies
    in its level (every level needs h, w >= 2); each quad corner's weight comes
    from its true coordinate, which keeps the zero padding exact."""
    bases, wts, start = [], [], 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x0, y0, fx, fy = _level_coords(locs[:, :, lvl], h, w)
        bx, by = x0.clamp(0, w - 2), y0.clamp(0, h - 2)
        bases.append((start + by * w + bx).to(torch.int32))
        cw = []
        for i in (0, 1):
            wy = torch.where(by + i == y0, 1 - fy, torch.where(by + i == y0 + 1, fy, 0.0))
            for j in (0, 1):
                wx = torch.where(bx + j == x0, 1 - fx, torch.where(bx + j == x0 + 1, fx, 0.0))
                cw.append(wx * wy)
        wts.append(torch.stack(cw, -1))  # (B, Q, P, 4)
        start += h * w
    cw = torch.stack(wts, 2)  # (B, Q, L, P, 4)
    return torch.stack(bases, 2), cw[..., None] * attn.permute(0, 1, 3, 4, 2)[:, :, :, :, None, :]


def corner_blocked(
    locs: torch.Tensor, spatial_shapes: Shapes, blk: int
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Point-major corners permuted so each group of 4 * blk rows holds blk
    items' corner-0 rows, then their corner-1, -2 and -3 rows
    (bench_msda2.py ``_corner_blocked``).  Items are (b, q, l, p); the last
    group is padded with index 0 and weight 0.  Returns indices into the
    batch-flattened (B*S, C) rows, (groups * 4 * blk,) int32, weights
    (groups, 4, blk) f32, the item count and the padding."""
    S = sum(h * w for h, w in spatial_shapes)
    idx, cw = corners_pmajor(locs, spatial_shapes)
    B = idx.shape[0]
    base = (torch.arange(B, dtype=torch.int32, device=idx.device) * S)[:, None, None, None, None]
    idx, cw = (idx + base).reshape(-1, 4), cw.reshape(-1, 4)
    n_items = idx.shape[0]
    n_pad = (-n_items) % blk
    idx = torch.nn.functional.pad(idx, (0, 0, 0, n_pad))
    cw = torch.nn.functional.pad(cw, (0, 0, 0, n_pad))
    groups = (n_items + n_pad) // blk
    idx = idx.reshape(groups, blk, 4).transpose(1, 2).reshape(-1)
    cw = cw.reshape(groups, blk, 4).transpose(1, 2).contiguous()
    return idx, cw, n_items, n_pad


# ---------------------------------------------------------------- plain versions


def gather_sum_plain(value: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """value (B, S, H, D), idx (B, H, Q, G) integer in [0, S) -> (B, H, Q, D) in
    the value dtype: out[b, h, q] = sum_g value[b, idx[b, h, q, g], h],
    accumulated in f32."""
    B, S, H, D = value.shape
    Q, G = idx.shape[2:]
    index = idx.long().reshape(B, H, Q * G, 1).expand(B, H, Q * G, D)
    rows = torch.gather(value.permute(0, 2, 1, 3), 2, index)
    return rows.reshape(B, H, Q, G, D).sum(3, dtype=torch.float32).to(value.dtype)


def weighted_reduce_plain(g: torch.Tensor, wt: torch.Tensor, K: int) -> torch.Tensor:
    """g (N, I, K*C) rows, wt (N, I, K*H) weights -> (N, C) f32:
    out[n, c] = sum_k sum_i g[n, i, k*C + c] * wt[n, i, k*H + c // D], D = C / H;
    the item sums first, then the K partial sums in order."""
    N, I, KC = g.shape
    C, H = KC // K, wt.shape[-1] // K
    prod = g.reshape(N, I, K, H, C // H).float() * wt.reshape(N, I, K, H, 1).float()
    s = prod.sum(1)
    acc = s[:, 0]
    for k in range(1, K):
        acc = acc + s[:, k]
    return acc.reshape(N, C)


def corner_collapse_blocked_plain(
    g: torch.Tensor, w: torch.Tensor, n_items: int, out_dtype: torch.dtype
) -> torch.Tensor:
    """g (groups, 4*blk, C) corner-blocked rows, w (groups, 4*blk) weights ->
    (n_items, C) in ``out_dtype``: for item j of group gi, with corner k at row
    k*blk + j, (g0*w0 + g1*w1) + (g2*w2 + g3*w3) in f32."""
    groups, rows, C = g.shape
    gw = (g.float() * w.float().reshape(groups, rows, 1)).reshape(groups, 4, rows // 4, C)
    out = (gw[:, 0] + gw[:, 1]) + (gw[:, 2] + gw[:, 3])
    return out.reshape(-1, C)[:n_items].to(out_dtype)


def corner_collapse_packed_plain(g: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """g (n, 4C) packed corner rows, w (n, 4) weights -> (n, C) in
    ``out_dtype``: ((g0*w0 + g1*w1) + g2*w2) + g3*w3 in f32, corner k in
    columns [k*C, (k+1)*C)."""
    n, C4 = g.shape
    gw = g.float().reshape(n, 4, C4 // 4) * w.float().reshape(n, 4, 1)
    return (((gw[:, 0] + gw[:, 1]) + gw[:, 2]) + gw[:, 3]).to(out_dtype)


# ---------------------------------------------------------------- kernel wrappers

_WEIGHT_TYPES = (torch.float32, torch.bfloat16)


def _require(ok: bool, exc, msg: str) -> None:
    if not ok:
        raise exc(msg)


def _check_rows(name: str, rows: torch.Tensor, *others: torch.Tensor) -> None:
    """Device, type, contiguity and 16-byte alignment of a kernel's bf16 rows,
    and that the other inputs are contiguous on the same device."""
    _require(rows.device.type == "cuda", RuntimeError, f"{name}: no kernel for device {rows.device}")
    _require(rows.dtype == torch.bfloat16, TypeError, f"{name}: rows must be bfloat16, got {rows.dtype}")
    _require(rows.is_contiguous() and rows.data_ptr() % 16 == 0, ValueError,
             f"{name}: rows must be contiguous and 16-byte aligned")
    for t in others:
        _require(t.device == rows.device, ValueError, f"{name}: all inputs must be on one device")
        _require(t.is_contiguous(), ValueError, f"{name}: inputs must be contiguous")


def _launch(name: str, like: torch.Tensor, *args) -> None:
    """Call the C entry point ``name`` (also its launch counter's key) on the
    current stream of ``like``'s device."""
    fn = getattr(native.load(), name)
    with torch.cuda.device(like.device):
        err = fn(*args, native.stream_of(like))
    native.check(err, name)
    native.LAUNCHES[name] += 1


def gather_sum(value: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5 (csrc/gather_sum.cu); same contract as :func:`gather_sum_plain`.  On
    CUDA: value a contiguous bf16 (B, S, H, 32) tensor, idx a contiguous
    int32 (B, H, Q, G) tensor; an index outside [0, S) adds nothing there
    (the kernel never reads it)."""
    if value.device.type == "cpu":
        return gather_sum_plain(value, idx)
    _check_rows("gather_sum", value, idx)
    _require(idx.dtype == torch.int32, TypeError, f"gather_sum: idx must be int32, got {idx.dtype}")
    _require(value.dim() == 4 and idx.dim() == 4 and idx.shape[:2] == (value.shape[0], value.shape[2]),
             ValueError, f"gather_sum: value (B,S,H,D) {tuple(value.shape)} and idx (B,H,Q,G) "
             f"{tuple(idx.shape)} disagree")
    B, S, H, D = value.shape
    Q, G = idx.shape[2:]
    _require(D == 32, ValueError, f"gather_sum: the kernel takes D=32, got D={D}")
    out = torch.empty((B, H, Q, D), dtype=value.dtype, device=value.device)
    if out.numel():
        _launch("gather_sum", value, value.data_ptr(), idx.data_ptr(), out.data_ptr(),
                B, S, H, D, Q, G)
    return out


def weighted_reduce(g: torch.Tensor, wt: torch.Tensor, K: int) -> torch.Tensor:
    """K6 (csrc/weighted_reduce.cu); same contract as
    :func:`weighted_reduce_plain`.  On CUDA: g a contiguous bf16 (N, I, K*C)
    tensor with C a multiple of 256, wt a contiguous f32 or bf16 (N, I, K*H)
    tensor with C / H a multiple of 8, K in {1, 2, 4}."""
    if g.device.type == "cpu":
        return weighted_reduce_plain(g, wt, K)
    _check_rows("weighted_reduce", g, wt)
    _require(wt.dtype in _WEIGHT_TYPES, TypeError, f"weighted_reduce: weights {wt.dtype} not f32/bf16")
    _require(K in (1, 2, 4) and g.dim() == 3 and wt.dim() == 3 and g.shape[:2] == wt.shape[:2]
             and g.shape[2] % K == 0 and wt.shape[2] % K == 0, ValueError,
             f"weighted_reduce: g {tuple(g.shape)}, wt {tuple(wt.shape)}, K={K}")
    N, I, KC = g.shape
    C, H = KC // K, wt.shape[2] // K
    _require(C % 256 == 0 and H > 0 and C % H == 0 and (C // H) % 8 == 0, ValueError,
             f"weighted_reduce: C={C} must be a multiple of 256 with C/H a multiple of 8 (H={H})")
    out = torch.empty((N, C), dtype=torch.float32, device=g.device)
    if N:
        _launch("weighted_reduce", g, g.data_ptr(), wt.data_ptr(), int(wt.dtype == torch.bfloat16),
                out.data_ptr(), N, I, K, C, H)
    return out


def _collapse_types(name: str, w: torch.Tensor, out_dtype: torch.dtype) -> None:
    _require(w.dtype in _WEIGHT_TYPES and out_dtype in _WEIGHT_TYPES, TypeError,
             f"{name}: weights {w.dtype} and output {out_dtype} must be f32 or bf16")


def corner_collapse_blocked(
    g: torch.Tensor, w: torch.Tensor, n_items: int, out_dtype: torch.dtype
) -> torch.Tensor:
    """K7 (csrc/corner_collapse.cu); same contract as
    :func:`corner_collapse_blocked_plain`.  On CUDA: g a contiguous bf16
    (groups, 4*blk, C) tensor with C a multiple of 256, w a contiguous f32 or
    bf16 tensor of groups * 4 * blk weights, n_items <= groups * blk; the
    padding items past n_items are not computed."""
    if g.device.type == "cpu":
        return corner_collapse_blocked_plain(g, w, n_items, out_dtype)
    name = "corner_collapse_blocked"
    _check_rows(name, g, w)
    _collapse_types(name, w, out_dtype)
    _require(g.dim() == 3 and g.shape[1] % 4 == 0 and g.shape[2] % 256 == 0
             and w.numel() == g.shape[0] * g.shape[1] and 0 <= n_items <= g.shape[0] * g.shape[1] // 4,
             ValueError, f"{name}: g {tuple(g.shape)}, w {tuple(w.shape)}, n_items={n_items}")
    C = g.shape[2]
    out = torch.empty((n_items, C), dtype=out_dtype, device=g.device)
    if n_items:
        _launch(name, g, g.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16),
                out.data_ptr(), int(out_dtype == torch.bfloat16), n_items, g.shape[1] // 4, C)
    return out


def corner_collapse_packed(g: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """K8 (csrc/corner_collapse.cu); same contract as
    :func:`corner_collapse_packed_plain`.  On CUDA: g a contiguous bf16
    (n, 4C) tensor with C a multiple of 256, w a contiguous f32 or bf16 (n, 4)
    tensor."""
    if g.device.type == "cpu":
        return corner_collapse_packed_plain(g, w, out_dtype)
    name = "corner_collapse_packed"
    _check_rows(name, g, w)
    _collapse_types(name, w, out_dtype)
    _require(g.dim() == 2 and g.shape[1] % 1024 == 0 and tuple(w.shape) == (g.shape[0], 4),
             ValueError, f"{name}: g {tuple(g.shape)} (n, 4C) and w {tuple(w.shape)} (n, 4)")
    n, C = g.shape[0], g.shape[1] // 4
    out = torch.empty((n, C), dtype=out_dtype, device=g.device)
    if n:
        _launch(name, g, g.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16),
                out.data_ptr(), int(out_dtype == torch.bfloat16), n, C)
    return out
