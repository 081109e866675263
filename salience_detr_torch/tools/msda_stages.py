"""The staged MSDA shootout on one CUDA card.

    python -m salience_detr_torch.tools.msda_stages [--q 11403 2281] [--iters 5]

The torch counterpart of the JAX tools' ``main()``s: tools/bench_msda2.py
(pipelines against the fused core), bench_msda3.py (kernel-only timings and
the row-width scan), bench_msda5.py (the corner collapse alone, and with bf16
weights) and bench_gather.py variant (c).  Each pipeline splits head-shared
MSDA into a row gather of the bilinear corners (plain ``index_select``, as
the JAX tools leave it to XLA), a stage kernel of
:mod:`salience_detr_torch.ops.msda_stages`, and, for the corner-collapse
pipelines, the per-head attention reduce as a plain ``einsum``:

========== ========================================== =====================
pipeline   gather layout                              stage kernel
========== ========================================== =====================
quad_pl    one 4C quad row per point                  K6, K = 4 corners
flat_pl    C-wide corner rows, items (l, corner)      K6, K = P points
pl_blk     corner-blocked C-wide rows                 K7, f32 out
pl_blk_bf16  same                                     K7, bf16 out
pl_nat     point-major C-wide rows (4C per point)     K8, f32 out
pl_nat_bf16  same                                     K8, bf16 out
pl_nat_bf16w same                                     K8, bf16 weights and out
========== ========================================== =====================

``gather_c`` (K5) sums G gathered per-head rows per query, unweighted; it is
checked against its plain version, not against MSDA.

In order, the CLI checks every pipeline at Q=256 against
``ms_deform_attn_plain`` (bench_msda2.py ``check``'s bound: rtol 0.05, atol
0.02); prints, for each ``--q``, the median of ``--iters`` CUDA-event timings
of each pipeline beside the fused kernel K1 (``ms_deform_attn``, G=1); the
kernel-only times of K6 (f32 and bf16 weights), K8 on rows padded to 512 and
2048 items and K8 with bf16 weights, beside their plain versions, on random
rows at the first ``--q``; and the row-width scan (rows of 512 B to 4 KB,
the quad path's gathered bytes, ``index_select`` + sum) in GB/s.  Exits 1
without a CUDA device or when a check fails.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import Callable, Dict

import torch

from salience_detr_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_plain
from salience_detr_torch.ops.msda_stages import (
    Shapes,
    build_quad,
    corner_blocked,
    corner_collapse_blocked,
    corner_collapse_packed,
    corner_collapse_packed_plain,
    corners_flat,
    corners_pmajor,
    gather_sum,
    gather_sum_plain,
    make_inputs,
    quad_base_and_weights,
    weighted_reduce,
    weighted_reduce_plain,
)
from salience_detr_torch.timing import card_line, cuda_times

# the shootout's shapes (tools/bench_msda2.py): the flagship's 800x1344 canvas
LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))
B, C, H = 4, 256, 8
BLK = 512  # items per corner-blocked group (bench_msda2.py _pl_blk_sampled)
GATHERS = 64  # rows per query of gather_c: L * P * 4
CHECK_RTOL, CHECK_ATOL = 0.05, 0.02  # bench_msda2.py check
# gather_c's bf16 output against its plain version: both round one f32 sum
# (one bf16 ulp, 2**-7 relative), summed in another order
GATHER_RTOL, GATHER_ATOL = 1e-2, 4e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, S, W), idx (B, ...) tokens within each batch element ->
    (idx.numel(), W): the row gather, one ``index_select`` of the flattened
    table."""
    B_, S, W = table.shape
    base = torch.arange(B_, dtype=idx.dtype, device=idx.device) * S
    flat = idx + base.reshape((B_,) + (1,) * (idx.dim() - 1))
    return torch.index_select(table.reshape(B_ * S, W), 0, flat.reshape(-1))


def quad_pl(value, spatial_shapes: Shapes, locs, w):
    """bench_msda2.py ``quad_pl``: one quad row per point, then K6 with the
    four corners as sub-rows.  value (B, S, C) bf16, locs (B, Q, L, P, 2),
    w (B, Q, H, L, P) -> (B, Q, C) f32."""
    B_, _, C_ = value.shape
    Q, L, P = locs.shape[1:4]
    base, wt = quad_base_and_weights(locs, w, spatial_shapes)
    g = gather_rows(build_quad(value, spatial_shapes), base).reshape(B_ * Q, L * P, 4 * C_)
    return weighted_reduce(g, wt.reshape(B_ * Q, L * P, -1), 4).reshape(B_, Q, C_)


def flat_pl(value, spatial_shapes: Shapes, locs, w):
    """bench_msda2.py ``flat_pl``: C-wide corner rows, items (level, corner)
    with the P points as sub-rows, then K6."""
    B_, _, C_ = value.shape
    Q, L, P = locs.shape[1:4]
    idx, cw = corners_flat(locs, spatial_shapes)  # (B, Q, L*4, P)
    g = gather_rows(value, idx).reshape(B_ * Q, L * 4, P * C_)
    attn = w.permute(0, 1, 3, 4, 2).repeat_interleave(4, dim=2)  # (B, Q, L*4, P, H)
    wt = cw[..., None] * attn
    return weighted_reduce(g, wt.reshape(B_ * Q, L * 4, -1), P).reshape(B_, Q, C_)


def _per_head(w: torch.Tensor, sampled: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Stage 2, einsum ``bqhlp,bqlphd->bqhd`` in f32 -> (B, Q, C).  With
    ``bf16`` the attention is rounded to bf16 first (the JAX tools' bf16
    einsum with an f32 result: bf16 products are exact in f32)."""
    B_, Q, H_, L, P = w.shape
    if bf16:
        w = w.to(torch.bfloat16)
    s = sampled.reshape(B_, Q, L, P, H_, -1).float()
    return torch.einsum("bqhlp,bqlphd->bqhd", w.float(), s).reshape(B_, Q, -1)


def _blk_sampled(value, spatial_shapes: Shapes, locs, out_dtype) -> torch.Tensor:
    idx, cw, n_items, _ = corner_blocked(locs, spatial_shapes, BLK)
    groups = cw.shape[0]
    g = torch.index_select(value.reshape(-1, value.shape[-1]), 0, idx)
    return corner_collapse_blocked(g.reshape(groups, 4 * BLK, -1), cw.reshape(groups, -1),
                                   n_items, out_dtype)


def pl_blk(value, spatial_shapes: Shapes, locs, w):
    """bench_msda2.py ``pl_blk``: corner-blocked rows, K7 (f32 out), einsum."""
    return _per_head(w, _blk_sampled(value, spatial_shapes, locs, torch.float32), False)


def pl_blk_bf16(value, spatial_shapes: Shapes, locs, w):
    """bench_msda2.py ``pl_blk_bf16``: K7 with bf16 out, bf16 einsum."""
    return _per_head(w, _blk_sampled(value, spatial_shapes, locs, torch.bfloat16), True)


def _nat_sampled(value, spatial_shapes: Shapes, locs, out_dtype, weight_dtype=torch.float32):
    idx, cw = corners_pmajor(locs, spatial_shapes)  # (B, Q, L, P, 4)
    n_items = cw.numel() // 4
    g = gather_rows(value, idx).reshape(n_items, -1)
    return corner_collapse_packed(g, cw.reshape(n_items, 4).to(weight_dtype), out_dtype)


def pl_nat(value, spatial_shapes: Shapes, locs, w):
    """bench_msda2.py ``pl_nat``: point-major rows, K8 (f32 out), einsum."""
    return _per_head(w, _nat_sampled(value, spatial_shapes, locs, torch.float32), False)


def pl_nat_bf16(value, spatial_shapes: Shapes, locs, w):
    """bench_msda2.py ``pl_nat_bf16``: K8 with bf16 out, bf16 einsum."""
    return _per_head(w, _nat_sampled(value, spatial_shapes, locs, torch.bfloat16), True)


def pl_nat_bf16w(value, spatial_shapes: Shapes, locs, w):
    """The pipeline of bench_msda5.py ``extra_probes.kern2d``: K8 with bf16
    corner weights and bf16 out, bf16 einsum."""
    sampled = _nat_sampled(value, spatial_shapes, locs, torch.bfloat16, torch.bfloat16)
    return _per_head(w, sampled, True)


PIPELINES: Dict[str, Callable] = {
    "quad_pl": quad_pl,
    "flat_pl": flat_pl,
    "pl_blk": pl_blk,
    "pl_blk_bf16": pl_blk_bf16,
    "pl_nat": pl_nat,
    "pl_nat_bf16": pl_nat_bf16,
    "pl_nat_bf16w": pl_nat_bf16w,
}


def gather_c(value: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bench_gather.py variant (c): value (B, S, H, D) bf16, idx (B, Q, H, G)
    int32 in [0, S) -> (B, H, Q, D) bf16, the sum of each query's G rows of
    its head (K5)."""
    return gather_sum(value, idx.permute(0, 2, 1, 3).contiguous())


def gather_inputs(Q: int, spatial_shapes: Shapes, generator=None, device="cpu"):
    """bench_gather.py's inputs: value (B, S, H, D) bf16 from a normal,
    random token indices (B, Q, H, G) int32 standing in for the corners."""
    S = sum(h * w for h, w in spatial_shapes)
    value = torch.randn(B, S, H, C // H, generator=generator, device=device).to(torch.bfloat16)
    idx = torch.randint(0, S, (B, Q, H, GATHERS), generator=generator, device=device, dtype=torch.int32)
    return value, idx


def check(fn: Callable, spatial_shapes: Shapes, Q: int = 256, batch: int = B, generator=None,
          device="cpu"):
    """bench_msda2.py ``check``: the pipeline against the plain MSDA on the
    shootout's inputs.  Returns (within rtol 0.05 / atol 0.02, max abs
    error)."""
    value, locs, w = make_inputs(Q, spatial_shapes, batch, generator=generator, device=device)
    want = ms_deform_attn_plain(value, spatial_shapes, locs[:, :, None], w).float()
    err = (fn(value, spatial_shapes, locs, w).float() - want).abs()
    return bool((err <= CHECK_ATOL + CHECK_RTOL * want.abs()).all()), float(err.max())


def check_gather(spatial_shapes: Shapes, Q: int = 256, generator=None, device="cpu"):
    """``gather_c`` against :func:`gather_sum_plain`: (within bound, max abs
    error)."""
    value, idx = gather_inputs(Q, spatial_shapes, generator, device)
    got = gather_c(value, idx).float()
    want = gather_sum_plain(value, idx.permute(0, 2, 1, 3)).float()
    err = (got - want).abs()
    return bool((err <= GATHER_ATOL + GATHER_RTOL * want.abs()).all()), float(err.max())


def _median_ms(fn: Callable, iters: int) -> float:
    return statistics.median(cuda_times(fn, iters))


def _kernel_only(Q: int, iters: int, gen: torch.Generator, dev) -> None:
    """K6 at bench_msda3.py's kernel_only shapes (N = B*Q padded to 128, I = 16,
    K = 4, random rows and weights) with f32 and bf16 weights; K8 at
    bench_msda5.py's (items padded to 512 and 2048 blocks, bf16 out) and with
    bf16 weights (1024 blocks); each beside its plain version."""
    N = -(-B * Q // 128) * 128
    g = torch.randn(N, 16, 4 * C, generator=gen, device=dev).to(torch.bfloat16)
    wt = torch.randn(N, 16, 4 * H, generator=gen, device=dev)
    floor = g.numel() * 2 / HBM_BYTES_PER_S * 1e3
    for name, weights in (("f32", wt), ("bf16", wt.to(torch.bfloat16))):
        ms = _median_ms(lambda: weighted_reduce(g, weights, 4), iters)
        plain = _median_ms(lambda: weighted_reduce_plain(g, weights, 4), iters)
        print(f"kernel_only K6 weighted_reduce N={N} I=16 K=4 weights {name}: {ms:.4f} ms "
              f"(plain {plain:.4f} ms; read floor {floor:.4f} ms at 3.35 TB/s)", flush=True)
    del g, wt
    items = B * Q * 16
    n_max = -(-items // 2048) * 2048
    rows = torch.randn(n_max, 4 * C, generator=gen, device=dev).to(torch.bfloat16)
    cw = torch.rand(n_max, 4, generator=gen, device=dev)
    for blk, wdtype in ((512, torch.float32), (2048, torch.float32), (1024, torch.bfloat16)):
        n = -(-items // blk) * blk
        g, w = rows[:n], cw[:n].to(wdtype)
        ms = _median_ms(lambda: corner_collapse_packed(g, w, torch.bfloat16), iters)
        plain = _median_ms(lambda: corner_collapse_packed_plain(g, w, torch.bfloat16), iters)
        floor = n * 5 * C * 2 / HBM_BYTES_PER_S * 1e3
        print(f"kernel_only K8 corner_collapse_packed items={n} (blk {blk}) weights "
              f"{str(wdtype)[6:]} out bf16: {ms:.4f} ms (plain {plain:.4f} ms; floor "
              f"{floor:.4f} ms)", flush=True)


def _width_scan(Q: int, iters: int, gen: torch.Generator, dev) -> None:
    """bench_msda3.py's width scan: the quad path's gathered bytes in rows of
    512 B to 4 KB, random rows of a (B*S, width) table, index_select + f32
    sum over the rows; GB/s = gathered bytes / time."""
    S = sum(h * w for h, w in LEVELS)
    total = B * Q * 16 * 4 * C * 2
    for elems in (256, 512, 1024, 2048):
        src = torch.randn(B * S, elems, generator=gen, device=dev).to(torch.bfloat16)
        idx = torch.randint(0, B * S, (total // (elems * 2),), generator=gen, device=dev)
        ms = _median_ms(lambda: torch.index_select(src, 0, idx).sum(0, dtype=torch.float32), iters)
        print(f"width {elems * 2}B: rows={idx.numel()} gathered={total / 1e9:.4f} GB "
              f"{ms:.4f} ms {total / ms / 1e6:.1f} GB/s", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--q", type=int, nargs="+", default=[11403, 2281],
                        help="query counts to time (11403: the first encoder layer)")
    parser.add_argument("--iters", type=int, default=5, help="timed calls per median")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("msda_stages: needs a CUDA device", file=sys.stderr)
        return 1
    print(f"{card_line()}; torch {torch.__version__}", flush=True)
    return run(args.q, args.iters, torch.device("cuda"))


def run(qs, iters: int, dev) -> int:
    """The checks, then the timings (see the module docstring), on inputs
    from seed 0; 1 if a check failed, else 0."""
    gen = torch.Generator(device=dev).manual_seed(0)

    failed = []
    for name, fn in PIPELINES.items():
        ok, err = check(fn, LEVELS, generator=gen, device=dev)
        print(f"check {name} vs ms_deform_attn_plain Q=256: max_abs_err={err:.3e} "
              f"(rtol {CHECK_RTOL} atol {CHECK_ATOL}) {'ok' if ok else 'FAILED'}", flush=True)
        failed += [] if ok else [name]
    ok, err = check_gather(LEVELS, generator=gen, device=dev)
    print(f"check gather_c vs gather_sum_plain Q=256: max_abs_err={err:.3e} "
          f"(rtol {GATHER_RTOL} atol {GATHER_ATOL}) {'ok' if ok else 'FAILED'}", flush=True)
    failed += [] if ok else ["gather_c"]

    for Q in qs:
        value, locs, w = make_inputs(Q, LEVELS, generator=gen, device=dev)
        locs6 = locs[:, :, None].contiguous()
        k1 = _median_ms(lambda: ms_deform_attn(value, LEVELS, locs6, w), iters)
        print(f"Q={Q} K1 ms_deform_attn (fused, G=1): {k1:.4f} ms", flush=True)
        for name, fn in PIPELINES.items():
            ms = _median_ms(lambda: fn(value, LEVELS, locs, w), iters)
            print(f"Q={Q} {name}: {ms:.4f} ms ({ms / k1:.2f}x K1)", flush=True)
        del value, locs, locs6, w
        gv, gidx = gather_inputs(Q, LEVELS, gen, dev)
        ms = _median_ms(lambda: gather_c(gv, gidx), iters)
        print(f"Q={Q} gather_c (K5, G={GATHERS} rows of {C // H * 2} B per (b, h, q)): {ms:.4f} ms "
              f"({ms / k1:.2f}x K1)", flush=True)
        del gv, gidx

    _kernel_only(qs[0], iters, gen, dev)
    _width_scan(qs[0], iters, gen, dev)
    if failed:
        print(f"msda_stages: checks failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
