"""ROADMAP C-20, the half that was unchecked: PyTorch's CPU backward of
``batch_norm`` misreads a gradient laid out as a slice of a (B, S, C) token
buffer when the batch has one image (channels-last strides with a batch
stride of C); the port's ``BatchNorm2d`` guards it (``_ContiguousGrad``).
Here the other norms the port trains are probed on the same layouts, at
batches of 1 (what a rank of a 2-way data-parallel CPU test holds) and 2:
``group_norm`` (the ChannelMapper's ``GroupNorm(32)``, and one group),
``layer_norm`` over the channels of an NCHW map (``LayerNorm2d``) and over
tokens (the transformer's and the backbones' LayerNorms).  Their input,
weight and bias gradients for each layout equal those for the contiguous
gradient (torch 2.13: bitwise), so none of them needs the guard.  The raw
``batch_norm`` case is kept as the probe's control: the port's
``BatchNorm2d`` must give the contiguous gradients on the layout where the
bare op may not."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from salience_detr_torch.models.layers import BatchNorm2d, ConvNormAct, LayerNorm2d

SHAPES = [(1, 32, 2, 2), (1, 32, 3, 4), (1, 256, 13, 21), (1, 64, 5, 1), (2, 32, 3, 4)]


def token_slice(g: torch.Tensor, skip: int = 7) -> torch.Tensor:
    """``g`` (B, C, H, W) as the slice of a (B, skip + H*W, C) token buffer."""
    B, C, H, W = g.shape
    tokens = torch.zeros(B, skip + H * W, C)
    tokens[:, skip:] = g.permute(0, 2, 3, 1).reshape(B, H * W, C)
    return tokens[:, skip:].transpose(1, 2).reshape(B, C, H, W)


LAYOUTS = {
    "token_slice": token_slice,
    "channels_last": lambda g: g.contiguous(memory_format=torch.channels_last),
    "nhwc_permuted": lambda g: g.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),
}


def grads(module, x, g):
    x = x.clone().requires_grad_()
    module.zero_grad(set_to_none=True)
    module(x).backward(g)
    return [x.grad] + [p.grad for p in module.parameters()]


def modules(C):
    layer_norm_2d = LayerNorm2d(C)
    with torch.no_grad():
        layer_norm_2d.weight.uniform_(0.5, 1.5)
        layer_norm_2d.bias.normal_()
    return {
        "group_norm_32": ConvNormAct(C, C, 1)[1],
        "group_norm_1": nn.GroupNorm(1, C),
        "layer_norm_2d": layer_norm_2d,
        "port_batch_norm": BatchNorm2d(C).train(),
    }


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ["group_norm_32", "group_norm_1", "layer_norm_2d", "port_batch_norm"])
def test_norm_backward_reads_every_gradient_layout(name, shape, layout):
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen)
    g = torch.randn(shape, generator=gen)
    odd = LAYOUTS[layout](g)
    assert torch.equal(odd, g)
    module = modules(shape[1])[name]
    want, got = grads(module, x, g), grads(module, x, odd)
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 12, 32), (2, 12, 32), (1, 273, 256), (1, 1, 64)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("layout", ["slice", "transposed"])
def test_token_layer_norm_backward_reads_every_gradient_layout(shape, layout):
    B, S, C = shape
    gen = torch.Generator().manual_seed(S)
    x, g = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    if layout == "slice":
        buf = torch.zeros(B, S + 7, C)
        buf[:, 7:] = g
        odd = buf[:, 7:]
    else:
        odd = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(odd, g)
    module = nn.LayerNorm(C)
    want, got = grads(module, x, g), grads(module, x, odd)
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


def test_bare_batch_norm_is_the_probe_control():
    """The layout that misled ``batch_norm`` (C-20) reaches the port's
    ``BatchNorm2d`` as a contiguous gradient: its gradients equal the
    contiguous case's whatever the bare op gives on that layout."""
    gen = torch.Generator().manual_seed(0)
    x, g = torch.randn(1, 32, 3, 4, generator=gen), torch.randn(1, 32, 3, 4, generator=gen)
    w = torch.rand(32, generator=gen).add_(0.5).requires_grad_()
    b = torch.randn(32, generator=gen).requires_grad_()

    class Bare(nn.Module):
        def __init__(self):
            super().__init__()
            self.w, self.b = nn.Parameter(w.detach().clone()), nn.Parameter(b.detach().clone())

        def forward(self, t):
            return F.batch_norm(t, None, None, self.w, self.b, True, 0.0, 1e-5)

    bare = Bare()
    bare_diff = max(float((a - c).abs().max()) for a, c in zip(grads(bare, x, g), grads(bare, x, token_slice(g))))
    port = BatchNorm2d(32).train()
    with torch.no_grad():
        port.weight.copy_(w)
        port.bias.copy_(b)
    for a, c in zip(grads(port, x, g), grads(port, x, token_slice(g))):
        torch.testing.assert_close(c, a, rtol=1e-6, atol=1e-6)
    print(f"bare batch_norm on the token-slice layout: max |diff| {bare_diff:.3e}")
