"""Multi-scale deformable attention sampling (port of salience_detr_tpu/ops/deform_attn.py).

One function covers every location-group count G (G divides the head count
H): G = 1 is the head-shared sampling of ``ms_deform_attn_core_shared``, G = H
the exact per-head sampling of ``ms_deform_attn_core`` /
``ms_deform_attn_core_quad``, and 1 < G < H the grouped sampling of
``ms_deform_attn_core_grouped``.  Head h uses location group h * G // H.

* :func:`ms_deform_attn_plain` is the plain PyTorch forward (explicit corner
  gathers), the spec of the forward kernel ``csrc/msda.cu``, and
  :func:`ms_deform_attn_backward_plain` the plain backward, the spec of the
  backward kernel ``csrc/msda_backward.cu``; both run on any device;
* :func:`ms_deform_attn` is the differentiable wrapper of the two kernels,
  the registered operator ``torch.ops.salience_detr.ms_deform_attn`` (with a
  fake implementation for ``torch.export``, an autograd formula and a FLOP
  formula): on CPU tensors its forward and backward are the plain versions,
  on CUDA tensors they launch the kernels or raise.  The backward has two
  designs for d_value (:func:`backward_design` picks one): the scatter of
  float atomics, and the ordered pull, bitwise repeatable, which runs under
  ``torch.use_deterministic_algorithms``;
* :func:`ms_deform_attn_q8` is the int8 head-shared sampling of the eval
  encoder (``MSDA_GATHER_QUANT=int8``), forward only, through the
  registered operators ``torch.ops.salience_detr.q8_quantize`` and
  ``q8_sample`` (``csrc/msda_q8.cu``), with its plain versions beside it.

Semantics: grid_sample with align_corners=False and zero padding; corners
outside their level get weight 0 and are never read (nor written by the
backward).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from salience_detr_torch import native
from salience_detr_torch.ops.misc import device_constant, flat_levels, level_pairs, refuse_meta


def compute_sampling_locations(
    reference_points: torch.Tensor,
    sampling_offsets: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    num_points: int,
) -> torch.Tensor:
    """reference_points (B, Q, L, 2) points or (B, Q, L, 4) boxes;
    sampling_offsets (B, Q, G, L, P, 2) -> locations (B, Q, G, L, P, 2)."""
    if reference_points.shape[-1] == 2:
        wh = device_constant(
            [(w, h) for h, w in spatial_shapes], sampling_offsets.device, sampling_offsets.dtype
        )
        return reference_points[:, :, None, :, None, :] + sampling_offsets / wh[:, None, :]
    if reference_points.shape[-1] == 4:
        return (
            reference_points[:, :, None, :, None, :2]
            + sampling_offsets / num_points * reference_points[:, :, None, :, None, 2:] * 0.5
        )
    raise ValueError(
        f"reference_points last dim must be 2 or 4, got {reference_points.shape[-1]}"
    )


def _check_shapes(value, spatial_shapes, locations, weights):
    if value.dim() != 3 or locations.dim() != 6 or weights.dim() != 5:
        raise ValueError(
            "expected value (B,S,C), locations (B,Q,G,L,P,2), weights (B,Q,H,L,P); got "
            f"{tuple(value.shape)}, {tuple(locations.shape)}, {tuple(weights.shape)}"
        )
    B, S, C = value.shape
    _, Q, G, L, P, two = locations.shape
    H = weights.shape[2]
    if (
        two != 2
        or locations.shape[:2] != (B, Q)
        or tuple(weights.shape) != (B, Q, H, L, P)
        or L != len(spatial_shapes)
        or sum(h * w for h, w in spatial_shapes) != S
        or C % H != 0
        or H % G != 0
    ):
        raise ValueError(
            f"inconsistent MSDA shapes: value {tuple(value.shape)}, levels "
            f"{list(spatial_shapes)}, locations {tuple(locations.shape)}, weights "
            f"{tuple(weights.shape)}"
        )
    return B, S, C, Q, G, L, P, H


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    locations: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """value (B, S, C) with padding zeroed; locations (B, Q, G, L, P, 2) in
    [0, 1] (x, y); weights (B, Q, H, L, P) -> (B, Q, C) in the value dtype,
    accumulated in f32."""
    B, S, C, Q, G, L, P, H = _check_shapes(value, spatial_shapes, locations, weights)
    D = C // H
    # rows of (B, S*H, D): token s, head h sits at s*H + h
    v = value.float().reshape(B, S * H, D)
    heads = torch.arange(H, device=value.device)
    group_of_head = heads * G // H
    loc = locations.float()[:, :, group_of_head]  # (B, Q, H, L, P, 2)
    attn = weights.float()
    out = torch.zeros(B, Q, H, D, dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5  # (B, Q, H, P)
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.long()
        y0i = y0.long()
        a = attn[:, :, :, lvl]  # (B, Q, H, P)
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                cx = x0i + dx
                cy = y0i + dy
                valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
                token = start + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
                row = (token * H + heads[:, None]).reshape(B, -1, 1).expand(-1, -1, D)
                rows = torch.gather(v, 1, row).reshape(B, Q, H, P, D)
                cw = torch.where(valid, wx * wy, torch.zeros_like(wx)) * a
                out += (cw[..., None] * rows).sum(dim=3)
        start += h * w
    return out.reshape(B, Q, C).to(value.dtype)


def ms_deform_attn_backward_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    locations: torch.Tensor,
    weights: torch.Tensor,
    d_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vector-Jacobian product of :func:`ms_deform_attn_plain`: d_out (B, Q, C)
    -> (d_value (B, S, C), d_locations (B, Q, G, L, P, 2), d_weights
    (B, Q, H, L, P)), each in its input's dtype, accumulated in f32.

    Per corner: d_weights gains cw * <d_out_h, row>, d_value gains
    attn * cw * d_out_h (``index_add_``), and d_locations the corner weight's
    derivative (d wx / d x = -1 or +1, times the level width) times
    attn * <d_out_h, row>, summed over the heads of each location group."""
    B, S, C, Q, G, L, P, H = _check_shapes(value, spatial_shapes, locations, weights)
    D = C // H
    v = value.float().reshape(B, S * H, D)
    heads = torch.arange(H, device=value.device)
    loc = locations.float()[:, :, heads * G // H]  # (B, Q, H, L, P, 2)
    attn = weights.float()
    g = d_out.float().reshape(B, Q, H, 1, D)
    d_v = torch.zeros(B * S * H, D, dtype=torch.float32, device=value.device)
    d_attn = torch.zeros(B, Q, H, L, P, dtype=torch.float32, device=value.device)
    d_x = torch.zeros(B, Q, H, L, P, dtype=torch.float32, device=value.device)
    d_y = torch.zeros_like(d_x)
    batch_rows = (torch.arange(B, device=value.device) * (S * H))[:, None, None, None]
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5  # (B, Q, H, P)
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.long()
        y0i = y0.long()
        a = attn[:, :, :, lvl]  # (B, Q, H, P)
        for dy, wy, sy in ((0, 1.0 - fy, -1.0), (1, fy, 1.0)):
            for dx, wx, sx in ((0, 1.0 - fx, -1.0), (1, fx, 1.0)):
                cx = x0i + dx
                cy = y0i + dy
                valid = ((cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)).float()
                token = start + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
                row = token * H + heads[:, None]  # (B, Q, H, P)
                rows = torch.gather(
                    v, 1, row.reshape(B, -1, 1).expand(-1, -1, D)
                ).reshape(B, Q, H, P, D)
                dot = (rows * g).sum(-1) * valid  # <d_out_h, row>, 0 off the level
                d_attn[:, :, :, lvl] += wx * wy * dot
                d_x[:, :, :, lvl] += sx * wy * a * dot
                d_y[:, :, :, lvl] += sy * wx * a * dot
                contrib = (a * wx * wy * valid)[..., None] * g  # (B, Q, H, P, D)
                d_v.index_add_(0, (row + batch_rows).reshape(-1), contrib.reshape(-1, D))
        start += h * w
    wh = device_constant([(w, h) for h, w in spatial_shapes], value.device)  # (L, 2)
    d_loc = torch.stack([d_x, d_y], -1) * wh[:, None]  # (B, Q, H, L, P, 2)
    d_loc = d_loc.reshape(B, Q, G, H // G, L, P, 2).sum(3)
    return (
        d_v.reshape(B, S, C).to(value.dtype),
        d_loc.to(locations.dtype),
        d_attn.to(weights.dtype),
    )


def _check_kernel_inputs(value, spatial_shapes, locations, weights):
    if value.device.type != "cuda":
        raise RuntimeError(f"ms_deform_attn: no kernel for device {value.device}")
    dims = _check_shapes(value, spatial_shapes, locations, weights)
    C, H = dims[2], dims[7]
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ms_deform_attn: value dtype {value.dtype} is not float32/bfloat16")
    if not value.is_contiguous() or value.data_ptr() % 16:
        raise ValueError("ms_deform_attn: value must be contiguous and 16-byte aligned")
    cpl = C // 32
    if C % 32 or cpl not in (1, 2, 8) or (C // H) % cpl:
        raise ValueError(
            f"ms_deform_attn: kernel takes C in (32, 64, 256) with C/H divisible by "
            f"C/32; got C={C}, H={H}"
        )
    if locations.device != value.device or weights.device != value.device:
        raise ValueError("ms_deform_attn: all inputs must be on one device")
    return dims


def _forward_cuda(value, spatial_shapes, locations, weights):
    B, S, C, Q, G, L, P, H = _check_kernel_inputs(value, spatial_shapes, locations, weights)
    loc = locations.to(torch.float32).contiguous()
    attn = weights.to(torch.float32).contiguous()
    out = torch.empty((B, Q, C), dtype=value.dtype, device=value.device)
    lib = native.load()
    with torch.cuda.device(value.device):
        err = lib.msda_forward(
            value.data_ptr(), int(value.dtype == torch.bfloat16),
            native.level_table(spatial_shapes), loc.data_ptr(), attn.data_ptr(),
            out.data_ptr(), B, S, Q, C, H, G, P, native.stream_of(value),
        )
    native.check(err, "msda_forward")
    native.LAUNCHES["msda"] += 1
    return out


def _backward_inputs(value, spatial_shapes, locations, weights, d_out):
    dims = _check_kernel_inputs(value, spatial_shapes, locations, weights)
    B, S, C, Q, G, L, P, H = dims
    if tuple(d_out.shape) != (B, Q, C) or d_out.device != value.device:
        raise ValueError(f"ms_deform_attn backward: d_out {tuple(d_out.shape)} != {(B, Q, C)}")
    loc = locations.to(torch.float32).contiguous()
    attn = weights.to(torch.float32).contiguous()
    grad = d_out.to(value.dtype).contiguous()
    d_loc = torch.empty((B, Q, G, L, P, 2), dtype=torch.float32, device=value.device)
    d_attn = torch.empty((B, Q, H, L, P), dtype=torch.float32, device=value.device)
    return dims, loc, attn, grad, d_loc, d_attn


def _backward_cuda(value, spatial_shapes, locations, weights, d_out):
    """K3, the scatter design: d_value accumulates by f32 atomics into a
    zeroed scratch buffer, cast once to the value dtype; d_locations and
    d_weights are written directly, in float32.  d_value's last bits vary
    from run to run."""
    (B, S, C, Q, G, L, P, H), loc, attn, grad, d_loc, d_attn = _backward_inputs(
        value, spatial_shapes, locations, weights, d_out)
    d_value = torch.zeros((B, S, C), dtype=torch.float32, device=value.device)
    lib = native.load()
    with torch.cuda.device(value.device):
        err = lib.msda_backward(
            value.data_ptr(), int(value.dtype == torch.bfloat16),
            native.level_table(spatial_shapes), loc.data_ptr(), attn.data_ptr(),
            grad.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(), d_attn.data_ptr(),
            B, S, Q, C, H, G, P, native.stream_of(value),
        )
    native.check(err, "msda_backward")
    native.LAUNCHES["msda_backward"] += 1
    return d_value.to(value.dtype), d_loc.to(locations.dtype), d_attn.to(weights.dtype)


def _backward_cuda_ordered(value, spatial_shapes, locations, weights, d_out):
    """K3, the ordered design: the entries sorted by value row, stably, so
    that each row's entries stay in key order; every d_value row summed in
    that order by a team of lanes and written once in the value dtype, with
    no float atomics, so the result is bitwise repeatable and the same bits
    whatever the sort's digits, tiles or the gather's block order.  The
    sort takes 8-bit digits (wider digits' tiles keep fewer blocks on an SM
    and cost more a pass than the pass they save), makes the entries in its
    first pass and writes the rows' bounds in its last; the gather keeps
    many warps an SM in flight, since its time is the latency of each
    entry's chain of loads (``csrc/msda_backward.cu`` says why each part is
    as it is).  Its scratch (the sort's two buffers of (row, key) pairs and
    the keys' weights, 20 bytes a corner, at G < H a copy of the attention
    weights, the digit counts and the rows' bounds) comes from the caching
    allocator.  d_locations and d_weights as in the scatter design."""
    (B, S, C, Q, G, L, P, H), loc, attn, grad, d_loc, d_attn = _backward_inputs(
        value, spatial_shapes, locations, weights, d_out)
    lib = native.load()
    table = native.level_table(spatial_shapes)
    nbytes = lib.msda_backward_workspace(table, B, S, Q, C, H, G, P)
    if nbytes < 0:
        raise ValueError(f"ms_deform_attn backward: the ordered design takes no B={B} Q={Q} G={G} L={L} "
                         f"P={P} (its keys are int32)")
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=value.device)
    d_value = torch.empty((B, S, C), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        err = lib.msda_backward_ordered(
            value.data_ptr(), int(value.dtype == torch.bfloat16), table, loc.data_ptr(),
            attn.data_ptr(), grad.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
            d_attn.data_ptr(), workspace.data_ptr(), B, S, Q, C, H, G, P, native.stream_of(value),
        )
    native.check(err, "msda_backward_ordered")
    native.LAUNCHES["msda_backward_ordered"] += 1
    return d_value, d_loc.to(locations.dtype), d_attn.to(weights.dtype)


BACKWARD_DESIGNS = {"scatter": _backward_cuda, "ordered": _backward_cuda_ordered}


def backward_design() -> str:
    """K3's design for this process's next backward, the one place it is
    chosen: "ordered" (bitwise repeatable) when
    ``torch.are_deterministic_algorithms_enabled()`` (the train CLI's
    ``--use-deterministic-algorithms``), else "scatter"."""
    return "ordered" if torch.are_deterministic_algorithms_enabled() else "scatter"


# K1 as a registered operator, ``torch.ops.salience_detr.ms_deform_attn``:
# its CPU implementation is the plain version and its CUDA implementation the
# kernel (which raises rather than giving way), its fake implementation makes
# the (B, Q, C) output from the shapes, so ``torch.export`` and FakeTensor
# trace through it and an exported program calls the kernel.  The levels go
# in flattened, (h0, w0, h1, w1, ...).
@torch.library.custom_op("salience_detr::ms_deform_attn", mutates_args=(), device_types="cpu",
                         schema="(Tensor value, Tensor locations, Tensor weights, int[] levels) -> Tensor")
def ms_deform_attn_op(value, locations, weights, levels):
    return ms_deform_attn_plain(value, level_pairs(levels), locations, weights)


@ms_deform_attn_op.register_kernel("cuda")
def _ms_deform_attn_op_cuda(value, locations, weights, levels):
    return _forward_cuda(value, level_pairs(levels), locations, weights)


@ms_deform_attn_op.register_fake
def _ms_deform_attn_op_fake(value, locations, weights, levels):
    refuse_meta(value, "ms_deform_attn")
    _check_shapes(value, level_pairs(levels), locations, weights)
    return value.new_empty((value.shape[0], locations.shape[1], value.shape[2]))


def ms_deform_attn_flops(value_shape, locations_shape, weights_shape, *args, out_shape=None, **kwargs) -> int:
    """FLOPs of one call as the plain version counts its multiply-adds: 4
    corners of D channels a (b, q, h, l, p), a multiply and an add each
    (2 x 4 x B x Q x C x L x P); the bilinear weights' arithmetic is not
    counted.  The formula ``torch.utils.flop_counter.FlopCounterMode``
    reads for the op."""
    B, Q, _, L, P, _ = locations_shape
    return 2 * 4 * B * Q * value_shape[2] * L * P


def _ms_deform_attn_setup_context(ctx, inputs, output):
    value, locations, weights, levels = inputs
    ctx.spatial_shapes = level_pairs(levels)
    ctx.save_for_backward(value, locations, weights)


def _ms_deform_attn_backward(ctx, d_out):
    """The op's backward: K3 (the design :func:`backward_design` names) on
    CUDA tensors, the plain backward on CPU tensors; nothing on CUDA gives
    way to a plain version or to the other design."""
    value, locations, weights = ctx.saved_tensors
    args = (value, ctx.spatial_shapes, locations, weights, d_out)
    if value.device.type == "cpu":
        grads = ms_deform_attn_backward_plain(*args)
    else:
        grads = BACKWARD_DESIGNS[backward_design()](*args)
    return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


ms_deform_attn_op.register_autograd(_ms_deform_attn_backward, setup_context=_ms_deform_attn_setup_context)


register_flop_formula(torch.ops.salience_detr.ms_deform_attn)(ms_deform_attn_flops)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    locations: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Differentiable MSDA through the kernels (csrc/msda.cu forward,
    csrc/msda_backward.cu backward), the op ``salience_detr::ms_deform_attn``;
    same contract as :func:`ms_deform_attn_plain`.

    On CUDA the value must be a contiguous float32 or bfloat16 tensor whose
    channels split into 32 lanes of 1, 2 or 8 channels each lying in one
    head (C in {32, 64, 256}); locations and weights are cast to float32
    for the kernels, since autocast does not reach a kernel call, and their
    gradients come back in their own dtypes.  A float16 value (fp16
    autocast) is sampled in float32 and the result cast back to float16.
    """
    levels = flat_levels(spatial_shapes)
    if value.dtype == torch.float16:
        return ms_deform_attn_op(value.float(), locations, weights, levels).to(torch.float16)
    return ms_deform_attn_op(value, locations, weights, levels)


# ---------------------------------------------------------------- int8 head-shared core (inference only)
#
# The port of ``ms_deform_attn_core_shared_q8`` (the JAX package's
# MSDA_GATHER_QUANT=int8 path of the G = 1 encoder in eval): the value is
# quantised to symmetric per-channel int8 once per call, the corners are
# sampled from the int8 rows, and the per-channel scale is applied once to the
# collapsed output.  The JAX core's quad-packed table and query chunking are
# TPU layouts: direct corner gathers of the int8 rows give the same corners
# and weights.  Its default reduction (``_Q8_REDUCE="einsum"``) feeds both
# einsums operands in the compute dtype, so the corner weights, the corner
# sums and the attention weights are rounded to the value dtype; the plain
# version here does the same, one IEEE operation at a time in the order of
# the kernels in ``csrc/msda_q8.cu``.


def q8_quantize_plain(value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """value (B, S, C) with padding zeroed -> (int8 table (B, S, C), scale
    (C,) float32): scale = max(per-channel absmax over B and S / 127, 1e-20),
    table = clip(round_half_even(value / scale), -127, 127).  The scale spans
    the whole batch, so an image's result depends on its batch-mates, as in
    the JAX package."""
    vf = value.float()
    absmax = vf.abs().amax(dim=(0, 1))
    # a divisor tensor on the value's device: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal, which rounds differently
    scale = (absmax / torch.full_like(absmax, 127.0)).clamp_min(1e-20)
    return torch.clamp(torch.round(vf / scale), -127, 127).to(torch.int8), scale


def _check_q8_shapes(table, spatial_shapes, locations, weights):
    if table.dim() != 3 or locations.dim() != 5 or weights.dim() != 5:
        raise ValueError(
            "expected value (B,S,C), locations (B,Q,L,P,2), weights (B,Q,H,L,P); got "
            f"{tuple(table.shape)}, {tuple(locations.shape)}, {tuple(weights.shape)}"
        )
    B, S, C = table.shape
    _, Q, L, P, two = locations.shape
    H = weights.shape[2]
    if (two != 2 or locations.shape[0] != B or tuple(weights.shape) != (B, Q, H, L, P)
            or L != len(spatial_shapes) or sum(h * w for h, w in spatial_shapes) != S or C % H):
        raise ValueError(
            f"inconsistent q8 MSDA shapes: value {tuple(table.shape)}, levels {list(spatial_shapes)}, "
            f"locations {tuple(locations.shape)}, weights {tuple(weights.shape)}"
        )
    return B, S, C, Q, L, P, H


def q8_sample_plain(
    table: torch.Tensor,
    scale: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    locations: torch.Tensor,
    weights: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """int8 table (B, S, C), scale (C,), head-shared locations (B, Q, L, P,
    2), weights (B, Q, H, L, P) -> (B, Q, C) in ``dtype`` (the value's, the
    JAX core's compute dtype).  Per point, s = sum over in-level corners of
    round(wx * wy) * q in float32, then out += round(attn) * round(s) over
    (level, point) in float32, times the scale, rounded to ``dtype``."""
    B, S, C, Q, L, P, H = _check_q8_shapes(table, spatial_shapes, locations, weights)
    D = C // H

    def rounded(t):
        return t.to(dtype).float()

    rows = table.float().reshape(B * S, C)
    loc = locations.float()
    attn = rounded(weights.float())
    batch = (torch.arange(B, device=table.device) * S)[:, None, None]
    out = torch.zeros(B, Q, H, D, dtype=torch.float32, device=table.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, lvl, :, 0] * w - 0.5  # (B, Q, P)
        y = loc[:, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        s = torch.zeros(B, Q, P, C, dtype=torch.float32, device=table.device)
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                cx, cy = x0i + dx, y0i + dy
                valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
                token = batch + start + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
                cw = rounded(torch.where(valid, wx * wy, torch.zeros_like(wx)))
                s = s + cw[..., None] * rows[token]
        s = rounded(s).reshape(B, Q, P, H, D)
        for p in range(P):
            out = out + attn[:, :, :, lvl, p, None] * s[:, :, p]
        start += h * w
    return (out.reshape(B, Q, C) * scale).to(dtype)


def ms_deform_attn_q8_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    locations: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """The plain int8 head-shared MSDA, the spec of ``ms_deform_attn_core_shared_q8``:
    value (B, S, C) with padding zeroed, locations (B, Q, L, P, 2), weights
    (B, Q, H, L, P) -> (B, Q, C) in the value dtype."""
    return q8_sample_plain(*q8_quantize_plain(value), spatial_shapes, locations, weights, value.dtype)


def _q8_quantize_cuda(value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantise kernel (one cooperative launch: the absmax pass, a grid
    barrier, the table pass) on a contiguous float32, bfloat16 or float16
    value, or raise.  The kernel takes the absmax scratch zeroed."""
    if value.dim() != 3 or value.dtype not in native.DTYPE_CODES or not value.is_contiguous():
        raise ValueError(f"q8_quantize: want a contiguous float32/bfloat16/float16 (B, S, C) value, got "
                         f"{value.dtype} {tuple(value.shape)}")
    B, S, C = value.shape
    if C % 8 or 256 % (C // 8) or value.data_ptr() % 16:
        raise ValueError(f"q8_quantize: kernel takes C with C / 8 dividing 256 and a 16-byte aligned value; "
                         f"got C={C}")
    absmax = torch.zeros(C, dtype=torch.int32, device=value.device)
    table = torch.empty((B, S, C), dtype=torch.int8, device=value.device)
    scale = torch.empty(C, dtype=torch.float32, device=value.device)
    lib = native.load()
    with torch.cuda.device(value.device):
        err = lib.msda_q8_quantize(value.data_ptr(), native.DTYPE_CODES[value.dtype], absmax.data_ptr(),
                                   table.data_ptr(), scale.data_ptr(), B * S, C, native.stream_of(value))
    native.check(err, "msda_q8_quantize")
    native.LAUNCHES["msda_q8_quantize"] += 1
    return table, scale


def _q8_sample_cuda(table, scale, spatial_shapes, locations, weights, dtype):
    """The sampling kernel, or raise.  It holds CPL int8 channels a lane,
    the largest of 16, 8, 4, 2, 1 that divides a head's C / H channels, and
    C / CPL lanes a query must divide 32: for C a power of two from 32 to
    512, any H that divides 32."""
    B, S, C, Q, L, P, H = _check_q8_shapes(table, spatial_shapes, locations, weights)
    if table.dtype != torch.int8 or not table.is_contiguous() or dtype not in native.DTYPE_CODES:
        raise TypeError(f"q8_sample: want a contiguous int8 table and a float32/bfloat16/float16 output, got "
                        f"{table.dtype} -> {dtype}")
    cpl = 16
    while C % H == 0 and (C // H) % cpl:
        cpl //= 2
    if C % H or C // cpl > 32 or 32 % (C // cpl):
        raise ValueError(f"q8_sample: kernel takes H dividing C and C / CPL lanes a query dividing 32, CPL "
                         f"the largest of 16, 8, 4, 2, 1 channels that divides C / H; got C={C}, H={H}")
    if scale.shape != (C,) or any(t.device != table.device for t in (scale, locations, weights)):
        raise ValueError("q8_sample: scale must be (C,) and all inputs on one device")
    loc = locations.to(torch.float32).contiguous()
    attn = weights.to(torch.float32).contiguous()
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty((B, Q, C), dtype=dtype, device=table.device)
    lib = native.load()
    with torch.cuda.device(table.device):
        err = lib.msda_q8_sample(
            table.data_ptr(), scale.data_ptr(), native.level_table(spatial_shapes),
            loc.data_ptr(), attn.data_ptr(), out.data_ptr(), native.DTYPE_CODES[dtype],
            B, S, Q, C, H, P, native.stream_of(table),
        )
    native.check(err, "msda_q8_sample")
    native.LAUNCHES["msda_q8_sample"] += 1
    return out


# B8 as two registered operators, ``torch.ops.salience_detr.q8_quantize`` and
# ``q8_sample``, dispatched as K1's: the plain versions on the CPU, the
# kernels on CUDA (which raise rather than give way), fake implementations
# from the shapes, so that ``torch.export`` traces the int8 encoder and a
# loaded program launches both kernels.  Forward only (the path is eval's).
@torch.library.custom_op("salience_detr::q8_quantize", mutates_args=(), device_types="cpu",
                         schema="(Tensor value) -> (Tensor, Tensor)")
def q8_quantize_op(value):
    return q8_quantize_plain(value)


@q8_quantize_op.register_kernel("cuda")
def _q8_quantize_op_cuda(value):
    return _q8_quantize_cuda(value)


@q8_quantize_op.register_fake
def _q8_quantize_op_fake(value):
    refuse_meta(value, "q8_quantize")
    if value.dim() != 3:
        raise ValueError(f"q8_quantize: want a (B, S, C) value, got {tuple(value.shape)}")
    return value.new_empty(value.shape, dtype=torch.int8), value.new_empty((value.shape[2],), dtype=torch.float32)


@torch.library.custom_op("salience_detr::q8_sample", mutates_args=(), device_types="cpu",
                         schema="(Tensor table, Tensor scale, Tensor locations, Tensor weights, int[] levels, "
                                "ScalarType dtype) -> Tensor")
def q8_sample_op(table, scale, locations, weights, levels, dtype):
    return q8_sample_plain(table, scale, level_pairs(levels), locations, weights, dtype)


@q8_sample_op.register_kernel("cuda")
def _q8_sample_op_cuda(table, scale, locations, weights, levels, dtype):
    return _q8_sample_cuda(table, scale, level_pairs(levels), locations, weights, dtype)


@q8_sample_op.register_fake
def _q8_sample_op_fake(table, scale, locations, weights, levels, dtype):
    refuse_meta(table, "q8_sample")
    B, S, C, Q, L, P, H = _check_q8_shapes(table, level_pairs(levels), locations, weights)
    return table.new_empty((B, Q, C), dtype=dtype)


def q8_sample_flops(table_shape, scale_shape, locations_shape, *args, out_shape=None, **kwargs) -> int:
    """FLOPs of one sample as :func:`ms_deform_attn_flops` counts K1's: 4
    corners of C channels a (b, q, l, p), a multiply and an add each."""
    B, Q, L, P, _ = locations_shape
    return 2 * 4 * B * Q * table_shape[2] * L * P


register_flop_formula(torch.ops.salience_detr.q8_sample)(q8_sample_flops)


def q8_quantize(value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op ``salience_detr::q8_quantize``: :func:`q8_quantize_plain` on a
    CPU tensor; on CUDA the quantise kernel on a contiguous float32,
    bfloat16 or float16 value, or raise."""
    return q8_quantize_op(value)


def q8_sample(
    table: torch.Tensor,
    scale: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    locations: torch.Tensor,
    weights: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """The op ``salience_detr::q8_sample``: :func:`q8_sample_plain` on CPU
    tensors; on CUDA the sampling kernel (output float32, bfloat16 or
    float16), or raise."""
    return q8_sample_op(table, scale, locations, weights, flat_levels(spatial_shapes), dtype)


def ms_deform_attn_q8(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    locations: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Forward-only int8 head-shared MSDA: :func:`ms_deform_attn_q8_plain` on
    CPU tensors, the two kernels of ``csrc/msda_q8.cu`` on CUDA tensors (or
    raise), each a registered operator; same contract as the plain version,
    for a float32, bfloat16 or float16 value (a float16 model rounds the
    corner weights, corner sums and attention weights to float16, as the JAX
    core computes in the value's dtype)."""
    table, scale = q8_quantize(value.contiguous())
    return q8_sample(table, scale, spatial_shapes, locations, weights, value.dtype)
