"""Modulated deformable convolution sampling, DCNv2 (port of the sampling of
salience_detr_tpu/models/bricks/deform_conv.py: ``_bilinear_sample_map``
times the modulation mask).

A 3x3 modulated deformable convolution is a sampling step, which gathers the
input at 9 deformed taps per output pixel and scales each by its mask, then
one GEMM of the sampled columns with the (9 * Cin, F) kernel.  This module
holds the sampling; the GEMM is a plain ``torch.matmul`` in
``models/bricks/deform_conv.py``, as the JAX package leaves its einsum to XLA.

* :func:`deform_conv_sample_plain` is the plain PyTorch forward, the spec of
  the forward kernel in ``csrc/deform_conv.cu``, and
  :func:`deform_conv_sample_backward_plain` the plain backward, the spec of
  the backward kernel there; both run on any device;
* :func:`deform_conv_sample` is the differentiable wrapper of the two kernels
  (a ``torch.autograd.Function``): on CPU tensors its forward and backward are
  the plain versions, on CUDA tensors they launch the kernels or raise.

Layouts are the JAX package's: x (B, H, W, Cin) channels-last; offsets (B,
Ho, Wo, 18) with (dy, dx) interleaved per tap; mask (B, Ho, Wo, 9); columns
(B, Ho, Wo, 9, Cin).  Taps run row-major over (ky, kx) in {-1, 0, 1}^2 and
sample at pixel ``(ho * stride + ky + dy, wo * stride + kx + dx)`` (pixel
units, no half-pixel shift), with 4 bilinear corners and zero padding: a
corner outside the image has weight 0 and is never read (nor written by the
backward).  The sample is summed in float32, multiplied by the mask and
rounded once to x's dtype.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from salience_detr_torch import native

TAPS = 9  # a 3x3 kernel with padding 1


def output_size(size: int, stride: int) -> int:
    """The output extent of a 3x3, padding 1 convolution."""
    return (size - 1) // stride + 1


def _check_shapes(x, offsets, mask, stride):
    if x.dim() != 4 or offsets.dim() != 4 or mask.dim() != 4:
        raise ValueError(
            "expected x (B,H,W,C), offsets (B,Ho,Wo,18), mask (B,Ho,Wo,9); got "
            f"{tuple(x.shape)}, {tuple(offsets.shape)}, {tuple(mask.shape)}"
        )
    B, H, W, C = x.shape
    Ho, Wo = output_size(H, stride), output_size(W, stride)
    if (
        stride < 1
        or tuple(offsets.shape) != (B, Ho, Wo, 2 * TAPS)
        or tuple(mask.shape) != (B, Ho, Wo, TAPS)
    ):
        raise ValueError(
            f"inconsistent deform-conv shapes at stride {stride}: x {tuple(x.shape)}, offsets "
            f"{tuple(offsets.shape)}, mask {tuple(mask.shape)} (want Ho, Wo = {Ho}, {Wo})"
        )
    return B, H, W, C, Ho, Wo


def _tap_positions(offsets: torch.Tensor, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(py, px), each (B, Ho, Wo, 9) float32: the grid point plus the tap
    (exact integers in float32), then plus the offset, rounded once."""
    B, Ho, Wo, _ = offsets.shape
    dev = offsets.device
    off = offsets.float().reshape(B, Ho, Wo, TAPS, 2)
    k = torch.arange(3, dtype=torch.float32, device=dev) - 1
    base_y = (torch.arange(Ho, dtype=torch.float32, device=dev) * stride)[:, None, None] + k.repeat_interleave(3)
    base_x = (torch.arange(Wo, dtype=torch.float32, device=dev) * stride)[None, :, None] + k.repeat(3)
    return base_y + off[..., 0], base_x + off[..., 1]


def _corners(py: torch.Tensor, px: torch.Tensor, H: int, W: int) -> Iterator:
    """The 4 bilinear corners of every tap, in the order (0, 0), (0, 1),
    (1, 0), (1, 1) of (dy, dx): (valid, flat row index b * H * W + y * W + x
    clamped into the image, wx, wy, d wx / d px, d wy / d py)."""
    B = py.shape[0]
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    y0i, x0i = y0.long(), x0.long()
    batch = (torch.arange(B, device=py.device) * (H * W)).view(B, 1, 1, 1)
    for dy, wy, sy in ((0, 1.0 - fy, -1.0), (1, fy, 1.0)):
        for dx, wx, sx in ((0, 1.0 - fx, -1.0), (1, fx, 1.0)):
            cy, cx = y0i + dy, x0i + dx
            valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            idx = batch + cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)
            yield valid, idx, wx, wy, sx, sy


def deform_conv_sample_plain(
    x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, stride: int
) -> torch.Tensor:
    """x (B, H, W, C), offsets (B, Ho, Wo, 18), mask (B, Ho, Wo, 9) -> the
    modulated columns (B, Ho, Wo, 9, C) in x's dtype: per tap the bilinear
    sample summed in float32 corner by corner, times the mask, rounded once."""
    B, H, W, C, Ho, Wo = _check_shapes(x, offsets, mask, stride)
    # cast before the gathers, so that autograd sums d_x in float32
    x_flat = x.reshape(B * H * W, C).float()
    out = None
    for valid, idx, wx, wy, _, _ in _corners(*_tap_positions(offsets, stride), H, W):
        w = torch.where(valid, wx * wy, torch.zeros_like(wx))
        term = w[..., None] * x_flat[idx]
        out = term if out is None else out + term
    return (out * mask.float()[..., None]).to(x.dtype)


def deform_conv_sample_backward_plain(
    x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, stride: int, d_cols: torch.Tensor,
    need_x: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vector-Jacobian product of :func:`deform_conv_sample_plain`: d_cols
    (B, Ho, Wo, 9, C) -> (d_x (B, H, W, C) or None without ``need_x``,
    d_offsets (B, Ho, Wo, 18), d_mask (B, Ho, Wo, 9)), each in its input's
    dtype, accumulated in float32.

    Per tap, with g = d_cols * mask: d_mask is <d_cols, sample>; each corner
    adds w * g to its pixel of d_x (``index_add_``) and, through d w / d px
    = +-wy and d w / d py = +-wx, its <g, row> to the offsets' gradients."""
    B, H, W, C, Ho, Wo = _check_shapes(x, offsets, mask, stride)
    x_flat = x.reshape(B * H * W, C).float()
    g = d_cols.float()
    gm = g * mask.float()[..., None]
    sampled = torch.zeros_like(g)
    d_py = torch.zeros(B, Ho, Wo, TAPS, dtype=torch.float32, device=x.device)
    d_px = torch.zeros_like(d_py)
    d_x = torch.zeros(B * H * W, C, dtype=torch.float32, device=x.device) if need_x else None
    for valid, idx, wx, wy, sx, sy in _corners(*_tap_positions(offsets, stride), H, W):
        rows = x_flat[idx]
        w = torch.where(valid, wx * wy, torch.zeros_like(wx))
        sampled += w[..., None] * rows
        dot = (gm * rows).sum(-1) * valid
        d_py += sy * wx * dot
        d_px += sx * wy * dot
        if need_x:
            d_x.index_add_(0, idx.reshape(-1), (w[..., None] * gm).reshape(-1, C))
    d_mask = (g * sampled).sum(-1)
    d_off = torch.stack([d_py, d_px], -1).reshape(B, Ho, Wo, 2 * TAPS)
    return (
        d_x.reshape(B, H, W, C).to(x.dtype) if need_x else None,
        d_off.to(offsets.dtype),
        d_mask.to(mask.dtype),
    )


def _check_kernel_inputs(x, offsets, mask, stride):
    if x.device.type != "cuda":
        raise RuntimeError(f"deform_conv_sample: no kernel for device {x.device}")
    dims = _check_shapes(x, offsets, mask, stride)
    C = dims[3]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"deform_conv_sample: x dtype {x.dtype} is not float32/bfloat16")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("deform_conv_sample: x must be contiguous (channels last) and 16-byte aligned")
    if C not in (32, 64, 128) and C % 256:
        raise ValueError(f"deform_conv_sample: kernel takes C in (32, 64, 128) or a multiple of 256; got {C}")
    if offsets.device != x.device or mask.device != x.device:
        raise ValueError("deform_conv_sample: all inputs must be on one device")
    return dims


def _forward_cuda(x, offsets, mask, stride):
    B, H, W, C, Ho, Wo = _check_kernel_inputs(x, offsets, mask, stride)
    off = offsets.to(torch.float32).contiguous()
    msk = mask.to(torch.float32).contiguous()
    cols = torch.empty((B, Ho, Wo, TAPS, C), dtype=x.dtype, device=x.device)
    lib = native.load()
    with torch.cuda.device(x.device):
        err = lib.deform_conv_forward(
            x.data_ptr(), int(x.dtype == torch.bfloat16), off.data_ptr(), msk.data_ptr(),
            cols.data_ptr(), B, H, W, C, stride, native.stream_of(x),
        )
    native.check(err, "deform_conv_forward")
    native.LAUNCHES["deform_conv"] += 1
    return cols


def _backward_cuda(x, offsets, mask, stride, d_cols, need_x=True):
    """d_x accumulates by float32 atomics into a zeroed scratch buffer, cast
    once to x's dtype (skipped without ``need_x``); d_offsets and d_mask are
    written directly, in float32."""
    B, H, W, C, Ho, Wo = _check_kernel_inputs(x, offsets, mask, stride)
    if tuple(d_cols.shape) != (B, Ho, Wo, TAPS, C) or d_cols.device != x.device:
        raise ValueError(f"deform_conv_sample backward: d_cols {tuple(d_cols.shape)} != "
                         f"{(B, Ho, Wo, TAPS, C)}")
    off = offsets.to(torch.float32).contiguous()
    msk = mask.to(torch.float32).contiguous()
    grad = d_cols.to(x.dtype).contiguous()
    d_x = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device) if need_x else None
    d_off = torch.empty((B, Ho, Wo, 2 * TAPS), dtype=torch.float32, device=x.device)
    d_mask = torch.empty((B, Ho, Wo, TAPS), dtype=torch.float32, device=x.device)
    lib = native.load()
    with torch.cuda.device(x.device):
        err = lib.deform_conv_backward(
            x.data_ptr(), int(x.dtype == torch.bfloat16), off.data_ptr(), msk.data_ptr(),
            grad.data_ptr(), d_x.data_ptr() if need_x else None, d_off.data_ptr(), d_mask.data_ptr(),
            B, H, W, C, stride, native.stream_of(x),
        )
    native.check(err, "deform_conv_backward")
    native.LAUNCHES["deform_conv_backward"] += 1
    return d_x.to(x.dtype) if need_x else None, d_off.to(offsets.dtype), d_mask.to(mask.dtype)


class _DeformConvSample(torch.autograd.Function):
    """Forward and backward kernels on CUDA tensors, the plain versions on CPU
    tensors; nothing on CUDA gives way to a plain version.  The backward
    skips the d_x scatter when x needs no gradient."""

    @staticmethod
    def forward(ctx, x, offsets, mask, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, offsets, mask)
        if x.device.type == "cpu":
            return deform_conv_sample_plain(x, offsets, mask, stride)
        return _forward_cuda(x, offsets, mask, stride)

    @staticmethod
    def backward(ctx, d_cols):
        x, offsets, mask = ctx.saved_tensors
        backward = deform_conv_sample_backward_plain if x.device.type == "cpu" else _backward_cuda
        grads = backward(x, offsets, mask, ctx.stride, d_cols, need_x=ctx.needs_input_grad[0])
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def deform_conv_sample(
    x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, stride: int
) -> torch.Tensor:
    """Differentiable modulated deformable sampling through the kernels
    (``csrc/deform_conv.cu``); same contract as :func:`deform_conv_sample_plain`.

    On CUDA, x must be a contiguous float32 or bfloat16 tensor with C in
    (32, 64, 128) or a multiple of 256 (32 lanes of 1, 2, 4 or 8 channels);
    offsets and mask are cast to float32 for the kernels, since autocast does
    not reach a kernel call, and their gradients come back in their dtypes.
    """
    return _DeformConvSample.apply(x, offsets, mask, int(stride))
