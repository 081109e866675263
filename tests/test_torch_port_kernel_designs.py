"""The algorithms of two kernels of ``salience_detr_torch/csrc/``, copied
step for step into numpy and held, on the CPU, against the plain PyTorch
versions (their specs) and the JAX package:

* the DCNv2 columns kernel (``deform_conv.cu`` ``deform_conv_forward_kernel``):
  groups of G lanes per (output pixel, chunk of G * VEC channels), VEC = 16
  bytes of x's dtype; the pixel's 18 offsets and 9 masks spread over the
  group's lanes and taken by shuffles; predicated corners (addresses clamped
  into the image, weight 0 outside it) issued 3 taps at a time; the corner
  sums in the plain version's order without fused multiply-adds, times the
  mask, rounded once.  Bitwise equal to ``deform_conv_sample_plain`` in
  float32, bfloat16 and float16, also where x holds inf or NaN in pixels that
  only clamped corners reach (0 * inf is NaN in both); within rtol 1e-5 (atol
  1e-6) of the JAX ``_bilinear_sample_map`` times the mask in float32, and
  within the rounding to x's dtype in the 16-bit types (rtol 2**-8 in
  bfloat16, 2**-11 in float16: the JAX sums stay float32 on the same x);
* the int8 quantisation (``msda_q8.cu`` ``q8_table_kernel``): a persistent
  grid of blocks over contiguous row slices in tiles of whole rows,
  per-thread and per-block absmax merged by max (the kernel's atomicMax of
  the bits), the scales after the grid barrier, the table from a second pass
  over the tiles in reverse order, each channel by the product with the
  scale's reciprocal and a magic-number rounding, and near a half-integer
  step by the sign of one fused residual (float64 holds the kernel's exact
  products, so each operation rounds once as its CUDA intrinsic).  Exactly
  equal to ``q8_quantize_plain`` and to the JAX quantisation (``scale =
  max(absmax / 127, 1e-20)``, ``clip(round(v / scale), -127, 127)``) for
  fewer rows than blocks, rows that are no multiple of the slice, a channel
  of zeros, values on half steps (round half to even), float32 and
  bfloat16; and the per-channel rule equal to the IEEE quotient's for every
  finite bfloat16 value, random float32 values and the half steps of the
  scale with 1 to 3 ulps beside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_torch.ops.deform_attn import q8_quantize_plain
from salience_detr_torch.ops.deform_conv import _corners, _tap_positions, deform_conv_sample_plain
from tests.test_torch_port_dcn import far_and_border_inputs, jax_sample, sample_inputs
from tests.torch_port_common import t

f32 = np.float32
TAPS, TAP_GROUP = 9, 3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
ROUNDING = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def lanes(C, dtype):
    """(G lanes per item, VEC channels a lane, channel chunks per pixel) of
    the columns kernel's launcher: VEC = 16 bytes of the dtype, G = C / VEC
    up to a warp, then chunks of 32 * VEC channels."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    G = C // vec if C < 32 * vec else 32
    return G, vec, C // (G * vec)


def columns_mirror(x, offsets, mask, stride, dtype):
    """A numpy copy of deform_conv_forward_kernel: x (B, H, W, C) float32
    holding values of ``dtype``, offsets (B, Ho, Wo, 18), mask (B, Ho, Wo, 9)
    -> the columns (B, Ho, Wo, 9, C) as a ``dtype`` tensor.  Every group of
    every warp is computed at once; each lane's slot registers, channel
    chunk and corner loads follow the kernel's index arithmetic."""
    B, H, W, C = x.shape
    Ho, Wo = offsets.shape[1:3]
    G, vec, chunks = lanes(C, dtype)
    items = B * Ho * Wo * chunks
    item = np.arange(items)
    pix = item // chunks
    wo, ho, b = pix % Wo, (pix // Wo) % Ho, pix // (Wo * Ho)
    off = offsets.reshape(B * Ho * Wo, 2 * TAPS).astype(f32)
    msk = mask.reshape(B * Ho * Wo, TAPS).astype(f32)
    regs = -(-3 * TAPS // G)
    # slot registers: lane ``sub`` of an item's group holds slots sub, sub + G, ...
    slot = np.zeros((items, G, regs), f32)
    for sub in range(G):
        for r in range(regs):
            s = sub + r * G
            if s < 2 * TAPS:
                slot[:, sub, r] = off[pix, s]
            elif s < 3 * TAPS:
                slot[:, sub, r] = msk[pix, s - 2 * TAPS]

    def get(s):  # __shfl_sync(v[s / G], s % G, width G)
        return slot[:, s % G, s // G]

    x_b = x.reshape(B, H * W, C).astype(f32)
    out = np.zeros((items, TAPS, G, vec), f32)
    one = f32(1)
    for k0 in range(0, TAPS, TAP_GROUP):
        issued = []  # the group's 4 * TAP_GROUP corner loads, before any sum
        for k in range(k0, k0 + TAP_GROUP):
            py = (ho * stride + k // 3 - 1).astype(f32) + get(2 * k)
            px = (wo * stride + k % 3 - 1).astype(f32) + get(2 * k + 1)
            y = np.minimum(np.maximum(py, f32(-2)), f32(H + 1))
            xf = np.minimum(np.maximum(px, f32(-2)), f32(W + 1))
            y0f, x0f = np.floor(y), np.floor(xf)
            y0, x0 = y0f.astype(np.int64), x0f.astype(np.int64)
            fy, fx = y - y0f, xf - x0f
            corners = []
            for dy in range(2):
                cy = y0 + dy
                wy = fy if dy else one - fy
                for dx in range(2):
                    cx = x0 + dx
                    valid = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
                    w = np.where(valid, (fx if dx else one - fx) * wy, f32(0)).astype(f32)
                    row = np.clip(cy, 0, H - 1) * W + np.clip(cx, 0, W - 1)
                    corners.append((w, x_b[b, row]))  # (items,), (items, C)
            issued.append(corners)
        for t_, corners in enumerate(issued):
            k = k0 + t_
            m = get(2 * TAPS + k)
            for sub in range(G):
                lane_c = (item % chunks)[:, None] * (G * vec) + sub * vec + np.arange(vec)
                acc = None
                for w, rows in corners:
                    term = w[:, None] * np.take_along_axis(rows, lane_c, 1)
                    acc = term if acc is None else acc + term
                out[:, k, sub] = acc * m[:, None]
    # item (pix, chunk) lane sub holds channels chunk * G * VEC + sub * VEC + [0, VEC)
    cols = out.reshape(B * Ho * Wo, chunks, TAPS, G * vec).transpose(0, 2, 1, 3)
    return torch.from_numpy(np.ascontiguousarray(cols).reshape(B, Ho, Wo, TAPS, C)).to(dtype)


def in_dtype(x, dtype):
    """x rounded to ``dtype`` and back to float32 numpy."""
    return torch.from_numpy(x).to(dtype).float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("C", [32, 512])
@pytest.mark.parametrize("case", ["random", "far_and_border"])
@pytest.mark.parametrize("stride", [1, 2])
def test_columns_mirror_matches_plain_and_jax(stride, case, C, dtype):
    dt = DTYPES[dtype]
    make = sample_inputs if case == "random" else far_and_border_inputs
    x, offsets, mask = make(stride, seed=50 + stride, B=2, H=9, W=11, C=C)
    x = in_dtype(x, dt)
    got = columns_mirror(x, offsets, mask, stride, dt)
    plain = deform_conv_sample_plain(t(x).to(dt), t(offsets), t(mask), stride)
    assert got.dtype == plain.dtype == dt
    assert torch.equal(got, plain)
    want = np.asarray(jax_sample(*map(jnp.asarray, (x, offsets, mask)), stride))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=ROUNDING[dt], atol=1e-6)
    if case == "far_and_border":
        assert (offsets.reshape(-1, 2)[:, 0] == -30.5).any()  # taps with no corner in the image


def clamped_only_pixels(offsets, stride, B, H, W):
    """The flat pixels (b * H * W + y * W + x) that corners outside the image
    reach through their clamped addresses and no corner inside it reaches."""
    py, px = _tap_positions(t(offsets), stride)
    inside, clamped = set(), set()
    for valid, idx, *_ in _corners(py, px, H, W):
        inside |= set(idx[valid].tolist())
        clamped |= set(idx[~valid].tolist())
    return sorted(clamped - inside)


def hidden_corner_inputs(stride, seed, B=2, H=9, W=11, C=64):
    """Offsets within 1 px on the left half of the output, and the right
    half's taps beyond the top-right and bottom-right corners of the image:
    those two pixels are read only through the clamped addresses of corners
    outside the image."""
    x, offsets, mask = sample_inputs(stride, seed, B, H, W, C)
    pairs = np.clip(offsets, -1, 1).reshape(*offsets.shape[:-1], 9, 2)
    right = np.arange(offsets.shape[2]) >= offsets.shape[2] // 2
    far = np.where(np.arange(9) % 2 == 0, -30.5, H + 30.5)  # above or below, per tap
    pairs[:, :, right, :, 0] = far
    pairs[:, :, right, :, 1] = W + 30.25
    return x, pairs.reshape(offsets.shape).astype(np.float32), mask


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("stride", [1, 2])
def test_columns_mirror_on_nonfinite_rows(stride, dtype):
    """inf and NaN in pixels that only clamped corners reach: the mirror
    equals the plain version, NaN for NaN (the plain version's 0 * inf)."""
    dt = DTYPES[dtype]
    B, H, W, C = 2, 9, 11, 64
    x, offsets, mask = hidden_corner_inputs(stride, seed=60 + stride, B=B, H=H, W=W, C=C)
    x = in_dtype(x, dt)
    hidden = clamped_only_pixels(offsets, stride, B, H, W)
    assert len(hidden) >= 2 * B
    flat = x.reshape(B * H * W, C)
    flat[hidden[0::2], 0::2] = np.inf
    flat[hidden[1::2], 1::2] = np.nan
    with np.errstate(invalid="ignore"):  # 0 * inf
        got = columns_mirror(x, offsets, mask, stride, dt)
    plain = deform_conv_sample_plain(t(x).to(dt), t(offsets), t(mask), stride)
    assert bool(plain.isnan().any()) and bool(torch.isfinite(plain).any())
    torch.testing.assert_close(got, plain, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got.isnan(), plain.isnan())


QUANT_THREADS, TILE_BYTES = 1024, 32768


ROUND_MAGIC, ROUND_BITS = f32(1.5 * 2 ** 23), 0x4B400000


def quantize_channels(v, s, r):
    """q = clip(rint(v / s), -127, 127) as the kernel takes it, v (..., C)
    float32, s and r = 1 / s rounded (C,) float32, every operation rounded
    once to float32 as its CUDA intrinsic (the exact products and sums held
    exactly in float64 first): y = fma(v, r, 1.5 * 2**23), whose bits are
    0x4B400000 + n, n = rint(v * r); d = fma(v, r, -n); where |d| is below
    fma(|n|, -2**-23, 1/2 - 2**-22), y's low byte; else, near the
    half-integer h = n + sign(d) / 2 with 1 < |h| < 128, rint(h) where |rem|
    <= s ulp(h) / 2 for rem = fma(-h, s, v), h -+ 1/2 by rem's sign
    otherwise; and the IEEE quotient (``__fdiv_rn``, ``rintf``) at |h| =
    1/2."""
    p = v.astype(np.float64) * r.astype(np.float64)  # 24 x 24 bits: exact
    n = np.rint(p)
    with np.errstate(invalid="ignore"):
        bound = (f32(0.5 - 2.0 ** -22) - np.abs(n) * 2.0 ** -23).astype(f32)
        fast = np.abs((p - n).astype(f32)) < bound
        h = n + np.copysign(0.5, p - n)
        half_ulp = (np.abs(h).astype(f32).view(np.int32) & 0x7F800000) - (24 << 23)
        threshold = (s.astype(np.float64) * half_ulp.astype(np.int32).view(f32)).astype(f32)  # exact
        rem = (v.astype(np.float64) - h * s.astype(np.float64)).astype(f32)  # 24 + 33 bits: exact, then one rounding
        near = np.where(np.abs(rem) <= threshold, np.rint(h), np.where(rem < 0, h - 0.5, h + 0.5))
        divided = np.rint((v / s).astype(f32))
    near = np.where((np.abs(h) > 1) & (np.abs(h) < 128), near, divided)
    y_bits = (ROUND_MAGIC + n.astype(f32)).astype(f32).view(np.int32)  # the magic sum, exact
    with np.errstate(invalid="ignore"):
        return np.where(fast, (y_bits & 0xFF).astype(np.uint8).view(np.int8),
                        np.clip(near, -127, 127)).astype(np.int8)


def quantize_mirror(value, grid, itemsize):
    """A numpy copy of q8_table_kernel on value (rows, C) float32 holding
    values of an ``itemsize``-byte dtype, over ``grid`` blocks: (table (rows,
    C) int8, scale (C,) float32).  Block i takes rows rows * i // grid to rows
    * (i + 1) // grid in tiles of whole rows (at most 32 KB); thread t takes
    16-byte words t, t + 1024, ... of every tile, VEC = 16 / itemsize
    channels each; pass 1 over the tiles in order, pass 2 in reverse
    order."""
    rows, C = value.shape
    vec = 16 // itemsize
    row_bytes = C * itemsize
    per_tile = max(1, TILE_BYTES // row_bytes)
    assert QUANT_THREADS % (C // vec) == 0  # a thread's words share their channels

    def tiles_of(r0, r1):
        return [(a, min(a + per_tile, r1)) for a in range(r0, r1, per_tile)]

    slices = [(rows * i // grid, rows * (i + 1) // grid) for i in range(grid)]
    absmax = np.zeros(C, np.uint32)
    for r0, r1 in slices:
        m = np.zeros((QUANT_THREADS, vec), f32)  # per-thread registers
        for a, b in tiles_of(r0, r1):
            words = np.abs(value[a:b]).reshape(-1, vec)  # word w -> thread w % 1024
            for w0 in range(0, len(words), QUANT_THREADS):
                part = words[w0:w0 + QUANT_THREADS]
                m[:len(part)] = np.maximum(m[:len(part)], part)
        # shared atomicMax of the bits over the threads of each chunk (t % (C / VEC))
        block = m.view(np.uint32).reshape(-1, C // vec, vec).max(axis=0).reshape(C)
        absmax = np.maximum(absmax, block)  # global atomicMax where nonzero
    scale = np.maximum(absmax.view(f32) / f32(127), f32(1e-20)).astype(f32)
    recip = (f32(1) / scale).astype(f32)
    table = np.zeros((rows, C), np.int8)
    written = np.zeros(rows, np.int64)
    for r0, r1 in slices:
        for a, b in reversed(tiles_of(r0, r1)):
            table[a:b] = quantize_channels(value[a:b], scale, recip)
            written[a:b] += 1
    assert (written == 1).all()  # every row once, whatever the slicing
    return table, scale


def quant_case(case, dtype, rng):
    if case == "fewer_rows_than_blocks":
        value = rng.normal(size=(5, 256)) * 3
    elif case == "ragged":
        value = rng.normal(size=(1001, 64)) * 3
    elif case == "zero_channel":
        value = rng.normal(size=(300, 32)) * 3
        value[:, 7] = 0.0
    elif case == "half_steps":  # absmax 127: scale 1, values k + 1/2 round half to even
        value = rng.integers(-127, 127, size=(400, 128)) + 0.5
        value[0] = 127.0
    else:  # narrow: one 8-channel chunk, 512 rows a block at a time
        value = rng.normal(size=(2000, 8))
    return in_dtype(value.astype(f32), dtype)


@pytest.mark.parametrize("grid", [1, 7, 132, 264])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["fewer_rows_than_blocks", "ragged", "zero_channel", "half_steps", "narrow"])
def test_quantize_mirror_matches_plain_and_jax(case, dtype, grid):
    dt = DTYPES[dtype]
    value = quant_case(case, dt, np.random.default_rng(70))
    table, scale = quantize_mirror(value, grid, torch.empty((), dtype=dt).element_size())
    want_table, want_scale = q8_quantize_plain(t(value).to(dt)[None])
    np.testing.assert_array_equal(table, want_table[0].numpy())
    np.testing.assert_array_equal(scale, want_scale.numpy())
    jv = jnp.asarray(value)
    jscale = jnp.maximum(jnp.max(jnp.abs(jv), axis=0) / 127.0, 1e-20)
    np.testing.assert_array_equal(scale, np.asarray(jscale))
    np.testing.assert_array_equal(table, np.asarray(jnp.clip(jnp.round(jv / jscale), -127, 127).astype(jnp.int8)))
    if case == "zero_channel":
        assert scale[7] == f32(1e-20) and not table[:, 7].any()
    if case == "half_steps":
        assert (scale == 1).all() and (table[value == 2.5] == 2).all() and (table[value == -3.5] == -4).all()


@pytest.mark.parametrize("absmax", [3.0, 1e-3, 127.0, 1e-19, 5e4])
def test_quantize_reciprocal_path_is_the_division(absmax):
    """The kernel's quotient by reciprocal, with the IEEE division near
    half-integers, gives clip(rint(v / s)) for every finite bfloat16 value
    within the absmax, random float32 values, and values on half steps of
    the scale and 1 to 3 ulps beside them."""
    rng = np.random.default_rng(71)
    scale = np.maximum(f32(absmax) / f32(127), f32(1e-20)).astype(f32)
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    every_bf16 = bits.view(f32)
    every_bf16 = every_bf16[np.isfinite(every_bf16) & (np.abs(every_bf16) <= f32(absmax))]
    half = ((np.arange(-127, 127) + f32(0.5)) * scale).astype(f32)
    near = [half]
    for direction in (np.inf, -np.inf):
        v = half
        for _ in range(3):
            v = np.nextafter(v, f32(direction)).astype(f32)
            near.append(v)
    values = np.concatenate([every_bf16, (rng.uniform(-1, 1, 200_000) * absmax).astype(f32)] + near)
    values = values[np.abs(values) <= f32(absmax)]
    got = quantize_channels(values[:, None], scale, (f32(1) / scale).astype(f32))[:, 0]
    want = np.clip(np.rint((values / scale).astype(f32)), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got, want)
    p = values.astype(np.float64) * np.float64((f32(1) / scale).astype(f32))
    assert (np.abs(p - np.rint(p)) >= 0.5 - 2.0 ** -23 * (np.abs(np.rint(p)) + 2)).any()  # the near-half path runs
