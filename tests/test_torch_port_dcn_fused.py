"""The port's DCNv2 layer function (``deform_conv2d``: the sampling and its
product with the kernel, the route of ``DeformConv2dPack``) against the JAX
package, on the CPU (plain versions), with inputs from numpy seeds.

Checked:

* forward and the VJP (d_x, d_offsets, d_mask, d_kernel) against
  ``jax.vjp`` of the JAX module's sampling times the mask and its einsum
  (``salience_detr_tpu/models/bricks/deform_conv.py:92-105``), with offsets
  and masks from the JAX ``DeformConv2dPack``'s own seeded nonzero offset
  and mask convs, at strides 1 and 2 in float32 (rtol 1e-3, atol 1e-5);
* the backward composition (the columns recomputed, d_cols and d_kernel by
  two ``torch.matmul``, the plain sampling backward): its kernel gradient and
  the d_cols it hands the sampling bitwise equal to autograd of the plain
  product, its sampling gradients bitwise equal to the plain sampling
  backward on that d_cols, and the whole within 1e-5 of autograd of
  ``deform_conv2d_plain`` (whose sampling gradients autograd sums in another
  order than the plain backward);
* a numpy mirror of the fused kernel's loop order (``csrc/deform_conv_gemm.cu``:
  pixel tiles, output-channel tiles, taps, 32-channel steps, each step's A
  tile sampled once and multiplied by each consumer warpgroup's rows or
  columns in two k = 16 halves, ragged last tiles zero-filled; the kernel's
  128 x 128 tile and its 64 x 256 tile of two column halves among the
  cases): its sampled tiles bitwise equal to the plain columns, each pixel
  sampled once a tap, channel and column tile, its output within rtol 1e-5
  of the plain layer;
* the kernel's tile by F (stages, shared memory, column tiles) and the
  route rule: which layers the CUDA route gives the fused kernel;
* float16: the layer function against the JAX module with ``dtype=float16``
  (rtol 4e-3, atol 4e-3: a few float16 ulps of outputs near 1, the final
  rounding of two sums taken in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks.deform_conv import DeformConv2dPack as JaxDCN
from salience_detr_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_plain,
    deform_conv_sample_backward_plain,
    deform_conv_sample_plain,
    output_size,
)
from tests.test_torch_port_dcn import dcn_variables, jax_sample
from tests.torch_port_common import t, two_torch_threads  # noqa: F401  (an autouse fixture)


def jax_layer_inputs(stride, seed, dtype=jnp.float32, B=2, H=10, W=13, cin=32, features=24):
    """x, the JAX module's offsets and mask (its seeded nonzero convs), its
    kernel (9, Cin, F) and output, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    jmod = JaxDCN(features, stride=stride, use_bias=False, dtype=dtype)
    variables = dcn_variables(jmod, jnp.asarray(x), seed=seed)
    out, inter = jmod.apply(variables, jnp.asarray(x, dtype), capture_intermediates=True,
                            mutable=["intermediates"])
    offsets = inter["intermediates"]["conv_offset"]["__call__"][0]
    mask = jax.nn.sigmoid(inter["intermediates"]["conv_mask"]["__call__"][0])
    kernel = variables["params"]["kernel"]
    return x, np.asarray(offsets), np.asarray(mask), np.asarray(kernel), np.asarray(out)


def jax_layer(x, offsets, mask, kernel, stride):
    """DeformConv2dPack's sampling, mask and einsum (deform_conv.py:74-105) on
    given offsets and mask, in float32."""
    sampled = jax_sample(x, offsets, mask, stride)
    return jnp.einsum("bhwkc,kcf->bhwf", sampled, kernel, preferred_element_type=jnp.float32)


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv2d_matches_jax(stride):
    x, offsets, mask, kernel, module_out = jax_layer_inputs(stride, seed=40 + stride)
    # the module's offsets move the taps a few pixels, off the pixel grid
    assert np.abs(offsets).mean() > 0.5 and (np.abs(offsets - np.round(offsets)) > 1e-3).mean() > 0.9
    want, vjp = jax.vjp(lambda *a: jax_layer(*a, stride), *map(jnp.asarray, (x, offsets, mask, kernel)))
    np.testing.assert_allclose(np.asarray(want), module_out, rtol=1e-5, atol=1e-6)
    inputs = [t(a).requires_grad_() for a in (x, offsets, mask, kernel)]
    got = deform_conv2d(*inputs, stride)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)

    cot = np.random.default_rng(50 + stride).normal(size=got.shape).astype(np.float32)
    got.backward(t(cot))
    for name, jg, a in zip(("d_x", "d_offsets", "d_mask", "d_kernel"), vjp(jnp.asarray(cot)), inputs):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_backward_composition_is_autograd_of_the_plain_pieces(stride, dtype):
    x, offsets, mask, kernel, _ = jax_layer_inputs(stride, seed=60 + stride)
    x = t(x).to(dtype)
    offsets, mask, kernel = t(offsets), t(mask), t(kernel)
    inputs = [a.clone().requires_grad_() for a in (x, offsets, mask, kernel)]
    out = deform_conv2d(*inputs, stride)
    assert out.dtype == dtype
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(61)).to(dtype)
    out.backward(d_out)

    # autograd of the plain product on the plain columns
    cols = deform_conv_sample_plain(x, offsets, mask, stride).requires_grad_()
    w = kernel.clone().requires_grad_()
    prod = torch.matmul(cols.reshape(-1, cols.shape[-2] * cols.shape[-1]), w.reshape(-1, w.shape[-1]).to(dtype))
    torch.testing.assert_close(out, prod.reshape(out.shape), rtol=0, atol=0)
    prod.backward(d_out.reshape(prod.shape))
    assert torch.equal(inputs[3].grad, w.grad) and inputs[3].grad.dtype == torch.float32
    want = deform_conv_sample_backward_plain(x, offsets, mask, stride, cols.grad)
    for name, a, g in zip(("d_x", "d_offsets", "d_mask"), inputs, want):
        assert a.grad.dtype == g.dtype and torch.equal(a.grad, g), name

    # the whole against autograd of deform_conv2d_plain, within the sampling
    # backward's summation order
    auto = [a.clone().requires_grad_() for a in (x, offsets, mask, kernel)]
    deform_conv2d_plain(*auto, stride).backward(d_out)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, b in zip(("d_x", "d_offsets", "d_mask", "d_kernel"), inputs, auto):
        err = float((a.grad.float() - b.grad.float()).abs().max())
        assert err <= rel * float(b.grad.float().abs().max()) + 1e-6, (name, err)


def sample_rows(x, offsets, mask, stride, pix, k, c0, c1):
    """The A tile of the fused kernel for output pixels ``pix`` (flat, < M),
    tap ``k`` and channels [c0, c1): deform_conv_forward_kernel's arithmetic
    in float32 (corners (0,0), (0,1), (1,0), (1,1), those outside the image
    skipped, times the mask), as numpy float32 operations."""
    f32 = np.float32
    B, H, W, C = x.shape
    Ho, Wo = offsets.shape[1:3]
    wo, ho, b = pix % Wo, (pix // Wo) % Ho, pix // (Wo * Ho)
    off = offsets.reshape(-1, 9, 2)[pix, k].astype(f32)
    m = mask.reshape(-1, 9)[pix, k].astype(f32)
    py = (ho * stride + k // 3 - 1).astype(f32) + off[:, 0]
    px = (wo * stride + k % 3 - 1).astype(f32) + off[:, 1]
    y = np.clip(py, f32(-2), f32(H + 1))
    xx = np.clip(px, f32(-2), f32(W + 1))
    y0, x0 = np.floor(y), np.floor(xx)
    fy, fx = y - y0, xx - x0
    y0, x0 = y0.astype(np.int64), x0.astype(np.int64)
    acc = np.zeros((len(pix), c1 - c0), f32)
    rows = x.reshape(B * H * W, C).astype(f32)
    for dy in (0, 1):
        for dx in (0, 1):
            cy, cx = y0 + dy, x0 + dx
            valid = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
            wgt = (fx if dx else f32(1) - fx) * (fy if dy else f32(1) - fy)
            r = (b * H + np.clip(cy, 0, H - 1)) * W + np.clip(cx, 0, W - 1)
            term = wgt[:, None] * rows[r, c0:c1]
            acc = np.where(valid[:, None], acc + term, acc)
    return acc * m[:, None]


def fused_mirror(x, offsets, mask, kernel, stride, BM, BN, BK, groups=(1, 1)):
    """The fused kernel's loop order in numpy: a (BM pixels, BN channels)
    tile at a time, one BK-channel step of one tap at a time (taps outer),
    the step's A tile sampled once, then each consumer warpgroup's part of
    the tile (``groups``: (row parts, column parts)) adds its rows of A
    times its columns of B in k = 16 halves, in float32, with the rows past
    M and the channels past F zero-filled; the tile stored without its
    ragged part.  Returns the output, the sampled A tiles as a (M, 9, C)
    array, and how often each (pixel, tap, channel) was sampled."""
    B, H, W, C = x.shape
    Ho, Wo = offsets.shape[1:3]
    M, F = B * Ho * Wo, kernel.shape[-1]
    w = kernel.reshape(9 * C, F).astype(np.float32)
    out = np.zeros((M, F), np.float32)
    cols = np.zeros((M, 9, C), np.float32)
    sampled = np.zeros((M, 9, C), np.int64)
    gm, gn = groups
    rows_g, cols_g = BM // gm, BN // gn
    for m0 in range(0, M, BM):
        pix = np.arange(m0, min(m0 + BM, M))
        for n0 in range(0, F, BN):
            acc = np.zeros((BM, BN), np.float32)
            for k in range(9):
                for c0 in range(0, C, BK):
                    a = np.zeros((BM, BK), np.float32)
                    a[:len(pix)] = sample_rows(x, offsets, mask, stride, pix, k, c0, c0 + BK)
                    cols[pix, k, c0:c0 + BK] = a[:len(pix)]
                    sampled[pix, k, c0:c0 + BK] += 1
                    b = np.zeros((BK, BN), np.float32)
                    part = w[k * C + c0:k * C + c0 + BK, n0:n0 + BN]
                    b[:, :part.shape[1]] = part
                    for g in range(gm * gn):
                        r, c = slice((g % gm) * rows_g, (g % gm + 1) * rows_g), slice((g // gm) * cols_g,
                                                                                      (g // gm + 1) * cols_g)
                        for kk in range(0, BK, 16):
                            acc[r, c] += a[r, kk:kk + 16] @ b[kk:kk + 16, c]
            out[pix, n0:n0 + BN] = acc[:len(pix), :min(BN, F - n0)]
    return out.reshape(B, Ho, Wo, F), cols.reshape(B, Ho, Wo, 9, C), sampled


@pytest.mark.parametrize("stride,tiles", [(1, (16, 16, 8)), (2, (16, 16, 32)), (1, (128, 128, 32)),
                                          (2, (128, 128, 32))])
def test_fused_mirror_matches_plain(stride, tiles):
    """Ragged last tiles on both sides (M = 2 * 7 * 9 or 2 * 4 * 5 pixels, F =
    24) at small tiles, and one tile covering all at the kernel's (two
    consumer warpgroups of 64 rows)."""
    x, offsets, mask, kernel, _ = jax_layer_inputs(stride, seed=70 + stride, H=7, W=9)
    groups = (2, 1) if tiles[0] == 128 else (1, 1)
    got, cols, sampled = fused_mirror(x, offsets, mask, kernel, stride, *tiles, groups)
    want_cols = deform_conv_sample_plain(t(x), t(offsets), t(mask), stride)
    assert torch.equal(torch.from_numpy(cols), want_cols)
    assert (sampled == -(-kernel.shape[-1] // tiles[1])).all()
    want = deform_conv2d_plain(t(x), t(offsets), t(mask), t(kernel), stride)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    M = x.shape[0] * output_size(x.shape[1], stride) * output_size(x.shape[2], stride)
    assert M % tiles[0] or tiles[0] > M
    assert kernel.shape[-1] % tiles[1] or tiles[1] > kernel.shape[-1]


SMEM_OPTIN_BYTES = 232448  # the H100's largest dynamic shared memory a block


def fused_tile(F):
    """launch_fused's tile by F (``Tile`` in csrc/deform_conv_gemm.cu):
    pixels, columns a consumer warpgroup (its wgmma's N), columns a tile,
    consumer parts (rows, columns), stages and the block's shared bytes
    (the stages' A and B tiles and the taps' table: 4 corner rows, 4
    weights and the mask of each pixel at each of the 9 taps)."""
    BM, wg_n, stages = (128 if F <= 128 else 64), 128, 4
    gm = BM // 64
    BN = wg_n * (2 // gm)
    stage = BM * 32 * 2 + 32 * BN * 2
    return BM, wg_n, BN, (gm, 2 // gm), stages, 1024 + stages * stage + 9 * BM * 9 * 4 + 16 * stages


@pytest.mark.parametrize("F", [128, 256, 512])
def test_fused_tile_samples_each_pixel_once_at_the_r50_dcn_widths(F):
    """At F = 128 one column tile of 128 pixels covers F (each consumer
    warpgroup 64 rows, m64n128); above, tiles of 64 pixels x 256 columns
    (each consumer 128 columns of the same A tile), so at F = 512 each
    pixel is sampled twice, once a column tile; the stages and the taps'
    table fit the shared memory.  At F = 512 the mirror of that tile (C =
    32, ragged pixels) samples each pixel once a column tile and holds the
    plain layer within rtol 1e-5."""
    BM, wg_n, BN, groups, stages, smem = fused_tile(F)
    assert wg_n == 128 and BM // groups[0] == 64 and BN // groups[1] == wg_n
    assert -(-F // BN) == (1 if F <= 256 else 2)
    assert stages >= 2 and smem <= SMEM_OPTIN_BYTES
    if F == 512:
        rng = np.random.default_rng(90)
        x = rng.normal(size=(1, 5, 6, 32)).astype(np.float32)
        offsets = (rng.normal(size=(1, 5, 6, 18)) * 2).astype(np.float32)
        mask = rng.uniform(size=(1, 5, 6, 9)).astype(np.float32)
        kernel = (rng.normal(size=(9, 32, F)) / 17).astype(np.float32)
        got, cols, sampled = fused_mirror(x, offsets, mask, kernel, 1, BM, BN, 32, groups)
        assert (sampled == F // BN).all()
        assert torch.equal(torch.from_numpy(cols), deform_conv_sample_plain(t(x), t(offsets), t(mask), 1))
        want = deform_conv2d_plain(t(x), t(offsets), t(mask), t(kernel), 1)
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,features,fused", [
    (torch.bfloat16, 128, True), (torch.float16, 64, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 256, False), (torch.float16, 512, False), (torch.bfloat16, 12, False),
    (torch.float32, 128, False), (torch.float32, 512, False),
])
def test_route_rule(dtype, features, fused):
    """16-bit x and F a multiple of 8 up to FUSED_MAX_F (R50-DCN's stage 2,
    where the fused kernel was as fast as or faster than the columns route
    in turns on the card) take the fused kernel; float32, F = 256 and 512
    (stages 3-4, where the columns route was faster) and F off the 8-channel
    grid take the columns route."""
    from salience_detr_torch.ops.deform_conv import FUSED_MAX_F, uses_fused_kernel

    assert FUSED_MAX_F == 128
    assert uses_fused_kernel(dtype, features) is fused


@pytest.mark.parametrize("stride", [1, 2])
def test_float16_layer_matches_jax(stride):
    """The layer function in float16 (x float16, the float32 kernel cast to
    float16, as under autocast) against the JAX module with dtype=float16 on
    the module's own offsets and mask: the columns rounded once to float16
    on both sides, then a float16 product summed in float32."""
    x, offsets, mask, kernel, want = jax_layer_inputs(stride, seed=80 + stride, dtype=jnp.float16)
    assert offsets.dtype == np.float16 and mask.dtype == np.float16 and want.dtype == np.float16
    xt = t(x).half().requires_grad_()
    got = deform_conv2d(xt, t(offsets.astype(np.float32)).half(), t(mask.astype(np.float32)).half(),
                        t(kernel), stride)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.detach().float().numpy(), want.astype(np.float32), rtol=4e-3, atol=4e-3)
    got.float().sum().backward()
    assert xt.grad.dtype == torch.float16 and bool(xt.grad.isfinite().all())
