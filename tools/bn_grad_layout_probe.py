"""``batch_norm``'s backward on a gradient laid out as a token slice.

    python tools/bn_grad_layout_probe.py

The gradient that reaches the neck's maps is a slice of a (B, S, C) token
gradient: channels-last strides with a batch stride of S*C; at one image
the batch stride is C, where the standard channels-last one is H*W*C.  For
each device present (the CPU, and the first CUDA card when there is one), a
few map shapes and batches of 1 and 2, this prints the largest difference between ``F.batch_norm``'s input,
weight and bias gradients for that layout and for the same gradient made
contiguous, and the same for the port's ``BatchNorm2d`` (which hands its
backward a contiguous gradient).  A difference well above float32 rounding
is a wrong gradient.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from salience_detr_torch.models.layers import BatchNorm2d  # noqa: E402

SHAPES = [(1, 32, 2, 2), (1, 32, 3, 4), (1, 256, 13, 21), (1, 256, 100, 168), (2, 32, 3, 4), (2, 256, 100, 168)]


def token_slice(g: torch.Tensor, skip: int = 7) -> torch.Tensor:
    """``g`` (B, C, H, W) as the slice of a (B, skip + H*W, C) token buffer."""
    B, C, H, W = g.shape
    tokens = torch.zeros(B, skip + H * W, C, device=g.device)
    tokens[:, skip:] = g.permute(0, 2, 3, 1).reshape(B, H * W, C)
    return tokens[:, skip:].transpose(1, 2).reshape(B, C, H, W)


def grads(forward, x, g, params):
    x = x.clone().requires_grad_()
    for p in params:
        p.grad = None
    forward(x).backward(g)
    return [x.grad] + [p.grad for p in params]


def main():
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for device in devices:
        gen = torch.Generator(device).manual_seed(0)
        for B, C, H, W in SHAPES:
            x = torch.randn(B, C, H, W, generator=gen, device=device)
            g = torch.randn(B, C, H, W, generator=gen, device=device)
            sliced = token_slice(g)
            assert torch.equal(sliced, g)
            w = torch.rand(C, generator=gen, device=device).add_(0.5).requires_grad_()
            b = torch.randn(C, generator=gen, device=device).requires_grad_()
            bare = lambda t: F.batch_norm(t, None, None, w, b, True, 0.0, 1e-5)  # noqa: E731
            bn = BatchNorm2d(C).to(device).train()
            diffs = {}
            for name, fwd, params in (("F.batch_norm", bare, [w, b]), ("BatchNorm2d", bn, list(bn.parameters()))):
                want, got = grads(fwd, x, g, params), grads(fwd, x, sliced, params)
                diffs[name] = max(float((a - c).abs().max()) for a, c in zip(want, got))
            print(f"bn_grad_layout: device={device} shape=({B}, {C}, {H}, {W}) strides={tuple(sliced.stride())} "
                  f"F.batch_norm max |diff| {diffs['F.batch_norm']:.3e}, port BatchNorm2d {diffs['BatchNorm2d']:.3e}")


if __name__ == "__main__":
    main()
