"""Modulated deformable convolution, DCNv2 (port of
salience_detr_tpu/models/bricks/deform_conv.py: ``_bilinear_sample_map``
times the modulation mask, then the einsum with the kernel).

A 3x3 modulated deformable convolution is a sampling step, which gathers the
input at 9 deformed taps per output pixel and scales each by its mask, then
one GEMM of the sampled columns with the (9 * Cin, F) kernel.

* :func:`deform_conv_sample_plain` is the plain PyTorch sampling, the spec of
  the columns kernel in ``csrc/deform_conv.cu``, and
  :func:`deform_conv_sample_backward_plain` its plain backward, the spec of
  the gather backward there; both run on any device;
* :func:`deform_conv_sample` is the differentiable wrapper of those two
  kernels (a ``torch.autograd.Function``): on CPU tensors its forward and
  backward are the plain versions, on CUDA tensors they launch the kernels
  or raise;
* :func:`deform_conv2d_plain` is the whole layer in plain PyTorch (the
  sampling, then ``torch.matmul`` in x's dtype), the spec of the fused
  kernel in ``csrc/deform_conv_gemm.cu``, and :func:`deform_conv2d` its
  differentiable wrapper, the layer's route (see its docstring): the fused
  kernel for 16-bit layers of F <= 128, the columns kernel and
  ``torch.matmul`` for the others.

Layouts are the JAX package's: x (B, H, W, Cin) channels-last; offsets (B,
Ho, Wo, 18) with (dy, dx) interleaved per tap; mask (B, Ho, Wo, 9); columns
(B, Ho, Wo, 9, Cin); the kernel (9, Cin, F); the output (B, Ho, Wo, F).
Taps run row-major over (ky, kx) in {-1, 0, 1}^2 and sample at pixel
``(ho * stride + ky + dy, wo * stride + kx + dx)`` (pixel units, no
half-pixel shift), with 4 bilinear corners and zero padding: a corner outside
the image has weight 0, times x at its address clamped into the image in the
forward (as the JAX package's ``_bilinear_sample_map`` takes it), and is not
written by the backward.  The
sample is summed in float32, multiplied by the mask and rounded once to x's
dtype (float32, bfloat16 or float16 on the card).
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


def deform_conv2d_plain(
    x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor, stride: int
) -> torch.Tensor:
    """x (B, H, W, Cin), offsets (B, Ho, Wo, 18), mask (B, Ho, Wo, 9), weight
    (9, Cin, F) -> (B, Ho, Wo, F) in x's dtype: the columns of
    :func:`deform_conv_sample_plain` times the kernel cast to x's dtype, one
    ``torch.matmul`` (the JAX einsum's operands in the compute dtype)."""
    return _product(deform_conv_sample_plain(x, offsets, mask, stride), weight)


def _kernel_matrix(weight: torch.Tensor, C: int) -> torch.Tensor:
    if weight.dim() != 3 or tuple(weight.shape[:2]) != (TAPS, C):
        raise ValueError(f"deform_conv2d: want a (9, {C}, F) kernel, got {tuple(weight.shape)}")
    return weight.reshape(TAPS * C, weight.shape[2])


# the C entry points' element-type codes (kFloat32, kBFloat16, kFloat16 in
# csrc/msda_common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_kernel_inputs(x, offsets, mask, stride):
    if x.device.type != "cuda":
        raise RuntimeError(f"deform_conv_sample: no kernel for device {x.device}")
    dims = _check_shapes(x, offsets, mask, stride)
    C = dims[3]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"deform_conv_sample: x dtype {x.dtype} is not float32/bfloat16/float16")
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
            x.data_ptr(), DTYPE_CODES[x.dtype], off.data_ptr(), msk.data_ptr(),
            cols.data_ptr(), B, H, W, C, stride, native.stream_of(x),
        )
    native.check(err, "deform_conv_forward")
    native.LAUNCHES["deform_conv"] += 1
    return cols


def _backward_cuda(x, offsets, mask, stride, d_cols, need_x=True):
    """The gather backward (``deform_conv_backward_gather``): d_x is summed
    per input pixel in registers and written once, in x's dtype (not at all
    without ``need_x``); d_offsets and d_mask in float32, cast to their
    inputs' dtypes.  Bitwise repeatable.  The scratch (per-pixel counts and
    lists, per-corner weights and dot products) is one workspace of the
    size the library names."""
    B, H, W, C, Ho, Wo = _check_kernel_inputs(x, offsets, mask, stride)
    if tuple(d_cols.shape) != (B, Ho, Wo, TAPS, C) or d_cols.device != x.device:
        raise ValueError(f"deform_conv_sample backward: d_cols {tuple(d_cols.shape)} != "
                         f"{(B, Ho, Wo, TAPS, C)}")
    off = offsets.to(torch.float32).contiguous()
    msk = mask.to(torch.float32).contiguous()
    grad = d_cols.to(x.dtype).contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()
    lib = native.load()
    ws_bytes = lib.deform_conv_backward_workspace(B, H, W, C, stride)
    if ws_bytes < 0:
        raise ValueError(f"deform_conv_sample backward: {B * Ho * Wo * TAPS * 4} corner keys at x "
                         f"{tuple(x.shape)} stride {stride} exceed the kernel's int32 keys")
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    d_x = torch.empty_like(x) if need_x else None
    d_off = torch.empty((B, Ho, Wo, 2 * TAPS), dtype=torch.float32, device=x.device)
    d_mask = torch.empty((B, Ho, Wo, TAPS), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.deform_conv_backward_gather(
            x.data_ptr(), DTYPE_CODES[x.dtype], off.data_ptr(), msk.data_ptr(),
            grad.data_ptr(), d_x.data_ptr() if need_x else None, d_off.data_ptr(), d_mask.data_ptr(),
            workspace.data_ptr(), B, H, W, C, stride, native.stream_of(x),
        )
    native.check(err, "deform_conv_backward_gather")
    native.LAUNCHES["deform_conv_backward"] += 1
    return d_x, d_off.to(offsets.dtype), d_mask.to(mask.dtype)


class _DeformConvSample(torch.autograd.Function):
    """Forward and backward kernels on CUDA tensors, the plain versions on CPU
    tensors; nothing on CUDA gives way to a plain version.  The backward
    writes no d_x when x needs no gradient."""

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

    On CUDA, x must be a contiguous float32, bfloat16 or float16 tensor with C in
    (32, 64, 128) or a multiple of 256 (the forward's lanes hold 16 bytes of
    channels each, C / 8 or C / 4 of them a pixel up to a warp);
    offsets and mask are cast to float32 for the kernels, since autocast does
    not reach a kernel call, and their gradients come back in their dtypes.
    """
    return _DeformConvSample.apply(x, offsets, mask, int(stride))


# the widest F the 16-bit route gives the fused kernel, from the two routes
# timed in turns on an H100 at R50-DCN's three widths (PERF.md §6): at F =
# 128 the fused kernel is as fast as the columns kernel + cuBLAS at the
# hottest shape and faster on a train step's captured layers, whose taps
# share more corner rows; at F = 256 and 512 each tile reads W's rows again,
# as much traffic as the corners, and the columns route is faster
FUSED_MAX_F = 128


def uses_fused_kernel(dtype: torch.dtype, features: int) -> bool:
    """Whether :func:`deform_conv2d` on CUDA runs a layer of x's ``dtype``
    and ``features`` output channels through the fused kernel: 16-bit x and
    F a multiple of 8 up to :data:`FUSED_MAX_F`."""
    return dtype in (torch.bfloat16, torch.float16) and features <= FUSED_MAX_F and features % 8 == 0


def _fused_cuda(x, offsets, mask, weight, stride):
    """The fused kernel (``deform_conv_fused_forward``): the sampling and the
    product on the tensor cores (wgmma) in x's 16-bit dtype, no columns
    written.  It takes any F a multiple of 8 (one launch: tiles of 128
    pixels x 128 channels up to F = 128, else 64 pixels x 256 channels);
    :func:`deform_conv2d` gives it F up to :data:`FUSED_MAX_F` only."""
    B, H, W, C, Ho, Wo = _check_kernel_inputs(x, offsets, mask, stride)
    w = _kernel_matrix(weight, C).to(x.dtype).contiguous()
    F = w.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"deform_conv2d: the fused kernel takes bfloat16/float16 x, got {x.dtype}")
    if C % 32 or F % 8 or w.data_ptr() % 16 or w.device != x.device:
        raise ValueError(f"deform_conv2d: the fused kernel takes Cin a multiple of 32 and F of 8 on x's "
                         f"device; got Cin={C}, F={F}")
    off = offsets.to(torch.float32).contiguous()
    msk = mask.to(torch.float32).contiguous()
    out = torch.empty((B, Ho, Wo, F), dtype=x.dtype, device=x.device)
    lib = native.load()
    with torch.cuda.device(x.device):
        err = lib.deform_conv_fused_forward(
            x.data_ptr(), DTYPE_CODES[x.dtype], off.data_ptr(), msk.data_ptr(), w.data_ptr(),
            out.data_ptr(), B, H, W, C, F, stride, native.stream_of(x),
        )
    native.check(err, "deform_conv_fused_forward")
    native.LAUNCHES["deform_conv_fused"] += 1
    return out


def _product(cols, weight):
    """cols (B, Ho, Wo, 9, C) @ the kernel in cols' dtype -> (B, Ho, Wo, F)."""
    B, Ho, Wo, _, C = cols.shape
    w = _kernel_matrix(weight, C).to(cols.dtype)
    return torch.matmul(cols.reshape(B * Ho * Wo, TAPS * C), w).reshape(B, Ho, Wo, -1)


class _DeformConv2d(torch.autograd.Function):
    """The layer's forward by dtype and F (see :func:`deform_conv2d`); the
    backward recomputes the columns (no columns are saved), takes d_cols =
    d_out @ W^T and dW = cols^T @ d_out by ``torch.matmul`` in x's dtype, then
    the sampling's backward (the gather kernel on CUDA, the plain backward on
    the CPU)."""

    @staticmethod
    def forward(ctx, x, offsets, mask, weight, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, offsets, mask, weight)
        # the product runs in x's dtype, whatever autocast the caller runs under
        with torch.autocast(x.device.type, enabled=False):
            if x.device.type == "cpu":
                return deform_conv2d_plain(x, offsets, mask, weight, stride)
            if uses_fused_kernel(x.dtype, weight.shape[-1]):
                return _fused_cuda(x, offsets, mask, weight, stride)
            return _product(_forward_cuda(x, offsets, mask, stride), weight)

    @staticmethod
    def backward(ctx, d_out):
        x, offsets, mask, weight = ctx.saved_tensors
        cpu = x.device.type == "cpu"
        cols = (deform_conv_sample_plain if cpu else _forward_cuda)(x, offsets, mask, ctx.stride)
        B, Ho, Wo, _, C = cols.shape
        w = _kernel_matrix(weight, C).to(x.dtype)
        g = d_out.reshape(B * Ho * Wo, -1).to(x.dtype)
        d_w = None
        if ctx.needs_input_grad[3]:
            d_w = torch.matmul(cols.reshape(B * Ho * Wo, TAPS * C).t(), g).reshape(weight.shape).to(weight.dtype)
        del cols
        d_cols = torch.matmul(g, w.t()).reshape(B, Ho, Wo, TAPS, C)
        backward = deform_conv_sample_backward_plain if cpu else _backward_cuda
        d_x, d_off, d_mask = backward(x, offsets, mask, ctx.stride, d_cols, need_x=ctx.needs_input_grad[0])
        grads = (d_x, d_off, d_mask)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), d_w, None)


def deform_conv2d(
    x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor, stride: int
) -> torch.Tensor:
    """The differentiable DCNv2 layer; same contract as
    :func:`deform_conv2d_plain`, the output in x's dtype.

    The forward's route is chosen by the tensors' device, x's dtype and the
    kernel's F alone (:func:`uses_fused_kernel`), never on a failure:

    * CPU tensors: :func:`deform_conv2d_plain`;
    * CUDA, x bfloat16 or float16 (serving and training under autocast) and
      F a multiple of 8 up to :data:`FUSED_MAX_F`: the fused kernel
      (``csrc/deform_conv_gemm.cu``, counted as ``deform_conv_fused``), the
      sampling and the product on the tensor cores (wgmma, its loads and
      sums in warpgroups of their own), no columns written;
    * CUDA, any other layer (x float32, or F above 128 or not a multiple of
      8): the columns kernel (counted as ``deform_conv``), then
      ``torch.matmul`` in x's dtype.  At F = 256 and 512 (R50-DCN's stages
      3-4) this is faster than the fused kernel on an H100: the fused
      kernel's tiles read W's rows again, as much traffic as the corners,
      where cuBLAS reads the columns once.

    Both CUDA routes take Cin in (32, 64, 128) or a multiple of 256, the
    columns kernel's set, which the backward's recompute also needs.

    The backward recomputes the columns (one ``deform_conv`` launch on
    CUDA), takes the two products by ``torch.matmul`` and runs the gather
    backward (``deform_conv_backward``).  The kernel is cast to x's dtype;
    its gradient comes back in its own dtype, as do those of offsets and
    mask.
    """
    return _DeformConv2d.apply(x, offsets, mask, weight, int(stride))
