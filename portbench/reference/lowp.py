"""The control's precision: the reference with every Linear and convolution
fed float8 (e4m3) operands, one scale per tensor, accumulated in float32 -
the step below the bfloat16 the configurations state.  The rounding passes
gradients straight through, so the control also trains."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, as float32;
    gradients pass straight through."""
    xf = x.float()
    scale = xf.detach().abs().amax().clamp(min=1e-12) / E4M3_MAX
    q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
    return xf + (q - xf).detach()


@contextlib.contextmanager
def float8_operands():
    linear, conv2d = F.linear, F.conv2d

    def q_linear(x, w, b=None):
        return linear(fp8(x), fp8(w), b)

    def q_conv2d(x, w, b=None, *args, **kwargs):
        return conv2d(fp8(x), fp8(w), b, *args, **kwargs)

    F.linear, F.conv2d = q_linear, q_conv2d
    try:
        yield
    finally:
        F.linear, F.conv2d = linear, conv2d
