"""OpenCV's uint8 image operations of the train path, without cv2.

The JAX package's augmentations call cv2 (``salience_detr_tpu/data/
transforms.py``, ``data/coco.py``); the CUDA card's machine has no cv2, PIL
or torchvision.  Each function here computes what its cv2 call computes, in
OpenCV's (and, for the JPEG round trip, libjpeg-turbo's) own integer or
float32 arithmetic, so the bytes are the same:

* :func:`rgb2hsv_u8` / :func:`hsv2rgb_u8` - ``cv2.cvtColor`` with
  ``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB`` on uint8 (hue range 180);
* :func:`box3_u8` - ``cv2.blur(img, (3, 3))``;
* :func:`median3_u8` - ``cv2.medianBlur(img, 3)``;
* :func:`jpeg_roundtrip_u8` - ``cv2.imdecode(cv2.imencode(".jpg", ...))``;
* :func:`fill_poly_u8` - ``cv2.fillPoly(mask, [pts], 1)``;
* :func:`fill_rect_into` / :func:`fill_ellipse_into` - a filled
  ``cv2.rectangle`` / full ``cv2.ellipse`` (angle 0, LINE_8) on a uint8
  image, in place;
* :func:`resize_nearest_u8` - ``cv2.resize(..., INTER_NEAREST)``;
* :func:`gaussian_blur5_f32` - ``cv2.GaussianBlur(alpha, (5, 5), sigma)``
  on float32 (within 1e-6; the others are exact).

Every function takes numpy arrays or CPU tensors and returns the type it
was given, but the ``*_into`` fills, which write into a numpy array in
place.  They are host operations of the loader's worker threads: numpy
over whole planes and all 8x8 blocks at once, no Python loop over pixels.
"""

from __future__ import annotations

import functools
import numpy as np
import torch


def _numpy_io(fn):
    """Run ``fn`` on the numpy view of a CPU tensor argument and give the
    result back as a tensor."""
    @functools.wraps(fn)
    def wrapper(img, *args, **kwargs):
        if isinstance(img, torch.Tensor):
            if img.device.type != "cpu":
                raise ValueError(f"{fn.__name__}: a host operation, got a tensor on {img.device}")
            return torch.from_numpy(np.ascontiguousarray(fn(img.numpy(), *args, **kwargs)))
        return fn(np.asarray(img), *args, **kwargs)
    return wrapper


def _reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    """Source indices of positions lo..hi-1 of a length-n axis under
    BORDER_REFLECT_101 (OpenCV's borderInterpolate, a length 1 axis reads
    index 0)."""
    p = np.arange(lo, hi)
    if n == 1:
        return np.zeros_like(p)
    while True:
        out = (p < 0) | (p >= n)
        if not out.any():
            return p
        p = np.where(p < 0, -p, np.where(p >= n, 2 * (n - 1) - p, p))


def _replicate(n: int, lo: int, hi: int) -> np.ndarray:
    return np.clip(np.arange(lo, hi), 0, n - 1)


# --------------------------------------------------------------------- HSV

_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int32)
_HDIV = np.zeros(256, np.int32)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64)))


@_numpy_io
def rgb2hsv_u8(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> HSV, equal to ``cv2.cvtColor(img,
    cv2.COLOR_RGB2HSV)``: OpenCV's fixed-point RGB2HSV_b (12-bit
    ``sdiv``/``hdiv`` tables rounded half to even, hue in [0, 180))."""
    px = img.astype(np.int32)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# the (b, g, r) entries of the tab[] of each hue sector (HSV2RGB_native)
_SECTORS = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


# HSV2RGB_b converts the pixels of a row in blocks of 4 float32 vectors (32
# pixels with the AVX2 code OpenCV dispatches on x86-64), truncating x * 255f;
# the row's last (W mod 32) pixels take the scalar code, which rounds
_HSV2RGB_BLOCK = 32


def _fma32(a, b, c):
    """float32 fused multiply-add a * b + c (one rounding): the product is
    exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


@_numpy_io
def hsv2rgb_u8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 HSV (hue range 180) -> RGB, equal to
    ``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)``: OpenCV's HSV2RGB_b in float32
    (s and v times 1/255f, the hue times 6f/180, the sector values v,
    v(1-s), v * fma(-s, h, 1) and v * fma(-s, 1-h, 1), as the compiler
    contracts them), then x * 255f truncated in the vector blocks of each
    row and rounded half to even in the row's tail."""
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(f32(6.0) / f32(180.0))
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    pre = np.trunc(h)
    h = h - pre
    sector = (pre - np.trunc(pre * f32(1.0 / 6.0)) * f32(6.0)).astype(np.int64)
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one), v * _fma32(-s, one - h, one)], -1)
    rgb = np.take_along_axis(tab, _SECTORS[sector], -1)[..., ::-1] * f32(255.0)
    W = img.shape[1]
    in_block = (np.arange(W) < W // _HSV2RGB_BLOCK * _HSV2RGB_BLOCK)[:, None]
    out = np.where(in_block, np.trunc(rgb), np.rint(rgb))
    return np.clip(out, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ filters


@_numpy_io
def box3_u8(img: np.ndarray) -> np.ndarray:
    """(H, W[, C]) uint8 -> the 3x3 mean, equal to ``cv2.blur(img, (3, 3))``:
    BORDER_REFLECT_101, the 9-sum scaled as OpenCV's uint8 box filter does,
    ((sum + 4) * 7282) >> 16."""
    H, W = img.shape[:2]
    px = img.astype(np.int32)
    rows = _reflect101(H, -1, H + 1)
    cols = _reflect101(W, -1, W + 1)
    p = px[rows][:, cols]
    s = p[:-2] + p[1:-1] + p[2:]
    s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
    return (((s + 4) * 7282) >> 16).astype(np.uint8)


# the 19 compare-exchanges of OpenCV's medianBlur_SortNet for a 3x3 window
_MEDIAN9 = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 3), (5, 8), (4, 7),
            (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4), (4, 2))


@_numpy_io
def median3_u8(img: np.ndarray) -> np.ndarray:
    """(H, W[, C]) uint8 -> the 3x3 median, equal to ``cv2.medianBlur(img,
    3)`` (BORDER_REPLICATE): the median of each window by the sorting
    network OpenCV uses."""
    H, W = img.shape[:2]
    p = img[_replicate(H, -1, H + 1)][:, _replicate(W, -1, W + 1)]
    v = [p[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    for a, b in _MEDIAN9:
        v[a], v[b] = np.minimum(v[a], v[b]), np.maximum(v[a], v[b])
    return np.ascontiguousarray(v[4])


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """OpenCV's INTER_NEAREST source index of each of ``n_out`` samples:
    min(floor(x * (1 / (n_out / n_in))), n_in - 1), in double."""
    return np.minimum(np.floor(np.arange(n_out) * (1.0 / (n_out / n_in))).astype(np.int64), n_in - 1)


@_numpy_io
def resize_nearest_u8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(h, w[, N]) uint8 -> (nh, nw[, N]), equal to ``cv2.resize(img, (nw,
    nh), interpolation=cv2.INTER_NEAREST)`` on any channel count (a mask
    stack): the rows and columns of :func:`nearest_index`."""
    h, w = img.shape[:2]
    return np.take(np.take(img, nearest_index(h, nh), axis=0), nearest_index(w, nw), axis=1)


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """OpenCV's getGaussianKernel(n, sigma > 0) as float32: exp(-x^2 / (2
    sigma^2)) over x = -(n-1)/2 ... (n-1)/2 in double, normalised by the
    reciprocal of the sum, rounded to float32."""
    x = np.arange(1 - n, n, 2, dtype=np.float64)
    t = np.exp(x * x * (-0.125 / (sigma * sigma)))
    half = (n - 1) // 2
    total = 2.0 * t[:half].sum() + 1.0 + (0.0 if n & 1 else 1.0)
    t = t * (1.0 / total)
    t[half] = 1.0 / total
    return t.astype(np.float32)


@_numpy_io
def gaussian_blur5_f32(alpha: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """(H, W) float32 -> ``cv2.GaussianBlur(alpha, (5, 5), sigma)`` within
    1e-6: the kernel of :func:`gaussian_kernel`, BORDER_REFLECT_101, a row
    pass then a column pass in float32, symmetric taps summed pairwise."""
    k = gaussian_kernel(5, sigma)
    H, W = alpha.shape
    a = alpha.astype(np.float32)
    p = a[:, _reflect101(W, -2, W + 2)]
    rows = p[:, 2:-2] * k[2] + (p[:, 1:-3] + p[:, 3:-1]) * k[1] + (p[:, :-4] + p[:, 4:]) * k[0]
    p = rows[_reflect101(H, -2, H + 2)]
    return (p[2:-2] * k[2] + (p[1:-3] + p[3:-1]) * k[1] + (p[:-4] + p[4:]) * k[0]).astype(np.float32)


# --------------------------------------------------------------------- JPEG
#
# What cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, q]) then
# cv2.imdecode(...) does to the pixels, as found against OpenCV 5.0 with
# libjpeg-turbo 3.1 (tests/test_torch_port_cv_ops.py holds every step):
# baseline YCbCr at 4:2:0 (Y 2x2, Cb and Cr 1x1), the islow integer DCT both
# ways, the standard tables scaled by jpeg_quality_scaling with
# force_baseline, h2v2 downsampling with the alternating 1, 2 bias, and the
# decoder's fancy (triangle) h2v2 upsampling - plain pixel replication where
# the chroma plane is 2 samples wide or less.  The Huffman bitstream is
# lossless and plays no part.

_LUMA_Q = np.asarray([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_CHROMA_Q = np.full(64, 99, np.int64)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

_FIX = {  # 13-bit constants of jfdctint.c / jidctint.c
    "0.298631336": 2446, "0.390180644": 3196, "0.541196100": 4433, "0.765366865": 6270,
    "0.899976223": 7373, "1.175875602": 9633, "1.501321110": 12299, "1.847759065": 15137,
    "1.961570560": 16069, "2.053119869": 16819, "2.562915447": 20995, "3.072711026": 25172,
}
_CONST_BITS, _PASS1_BITS = 13, 2


def quant_tables(quality: int):
    """The (luma, chroma) quantisation tables of ``jpeg_set_quality(cinfo,
    quality, force_baseline=TRUE)``, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((base * scale + 50) // 100, 1, 255) for base in (_LUMA_Q, _CHROMA_Q))


def _fdct_1d(t):
    """jpeg_fdct_islow's butterfly on axis 0 of ``t`` (8, ...), before any
    descaling: every output is an integer combination of the inputs."""
    f = _FIX
    tmp0, tmp7 = t[0] + t[7], t[0] - t[7]
    tmp1, tmp6 = t[1] + t[6], t[1] - t[6]
    tmp2, tmp5 = t[2] + t[5], t[2] - t[5]
    tmp3, tmp4 = t[3] + t[4], t[3] - t[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * f["0.541196100"]
    out = [None] * 8
    out[0], out[4] = tmp10 + tmp11, tmp10 - tmp11
    out[2] = z1 + tmp13 * f["0.765366865"]
    out[6] = z1 - tmp12 * f["1.847759065"]
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * f["1.175875602"]
    z1 = z1 * -f["0.899976223"]
    z2 = z2 * -f["2.562915447"]
    z3 = z3 * -f["1.961570560"] + z5
    z4 = z4 * -f["0.390180644"] + z5
    out[7] = tmp4 * f["0.298631336"] + z1 + z3
    out[5] = tmp5 * f["2.053119869"] + z2 + z4
    out[3] = tmp6 * f["3.072711026"] + z2 + z3
    out[1] = tmp7 * f["1.501321110"] + z1 + z4
    return np.stack(out)


def _idct_1d(t):
    """jpeg_idct_islow's butterfly on axis 0 of ``t`` (8, ...), before any
    descaling (its DC-only shortcuts are the same arithmetic)."""
    f = _FIX
    z2, z3 = t[2], t[6]
    z1 = (z2 + z3) * f["0.541196100"]
    tmp2 = z1 - z3 * f["1.847759065"]
    tmp3 = z1 + z2 * f["0.765366865"]
    tmp0 = (t[0] + t[4]) << _CONST_BITS
    tmp1 = (t[0] - t[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = t[7], t[5], t[3], t[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * f["1.175875602"]
    z1 = z1 * -f["0.899976223"]
    z2 = z2 * -f["2.562915447"]
    z3 = z3 * -f["1.961570560"] + z5
    z4 = z4 * -f["0.390180644"] + z5
    tmp0 = tmp0 * f["0.298631336"] + z1 + z3
    tmp1 = tmp1 * f["2.053119869"] + z2 + z4
    tmp2 = tmp2 * f["3.072711026"] + z2 + z3
    tmp3 = tmp3 * f["1.501321110"] + z1 + z4
    return np.stack([tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                     tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3])


def _pass(x, butterfly, shift, descale):
    """One 1-D pass along the last axis of ``x`` (..., 8) int64: output i
    is the butterfly's combination times 2^shift[i], then DESCALE'd
    (rounded half up) by descale[i] bits.  Plain integer numpy: no BLAS
    threads in the loader's workers."""
    y = np.moveaxis(butterfly(np.moveaxis(x, -1, 0)), 0, -1) << shift
    return (y + np.where(descale > 0, 1 << np.maximum(descale - 1, 0), 0)) >> descale


_EVEN = np.isin(np.arange(8), (0, 4))
# jpeg_fdct_islow's passes: outputs 0 and 4 of the row pass are only scaled
# up by PASS1_BITS, those of the column pass descaled by PASS1_BITS
_FDCT_ROWS = (np.where(_EVEN, _PASS1_BITS, 0), np.where(_EVEN, 0, _CONST_BITS - _PASS1_BITS))
_FDCT_COLS = (np.zeros(8, np.int64), np.where(_EVEN, _PASS1_BITS, _CONST_BITS + _PASS1_BITS))
_IDCT_COLS = (np.zeros(8, np.int64), np.full(8, _CONST_BITS - _PASS1_BITS))
_IDCT_ROWS = (np.zeros(8, np.int64), np.full(8, _CONST_BITS + _PASS1_BITS + 3))


def _divisors(qtable):
    """libjpeg-turbo's compute_reciprocal(q << 3): reciprocal, correction
    and shift of the 16-bit quantiser (exact division for these divisors is
    not what it computes, so it is reproduced)."""
    d = qtable.astype(np.int64) << 3
    b = np.floor(np.log2(d)).astype(np.int64)
    r = 16 + b
    fq = (np.int64(1) << r) // d
    fr = (np.int64(1) << r) % d
    c = d // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > d // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    return fq, c, r


def _post_idct_limit(x):
    """jidctint's range limit: the table lookup of (x & 1023) past
    CENTERJSAMPLE, which clamps [-384, 383] + 128 and wraps beyond."""
    i = x & 1023
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896)))


def _code_plane(plane, qtable):
    """Encode and decode one padded plane (H, W multiples of 8): fdct,
    quantise, dequantise, idct, range limit, all blocks at once (blocks[i,
    j, v, u]: block (i, j)'s row v, column u)."""
    H, W = plane.shape
    blocks = plane.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).astype(np.int64) - 128
    t = _pass(blocks, _fdct_1d, *_FDCT_ROWS)
    t = _pass(t.swapaxes(-1, -2), _fdct_1d, *_FDCT_COLS).swapaxes(-1, -2)  # t[.., v, u], natural order
    recip, corr, shift = (a.reshape(8, 8) for a in _divisors(qtable))
    q = ((np.abs(t) + corr) * recip) >> shift
    coef = np.where(t < 0, -q, q) * qtable.reshape(8, 8)
    t = _pass(coef.swapaxes(-1, -2), _idct_1d, *_IDCT_COLS).swapaxes(-1, -2)
    t = _pass(t, _idct_1d, *_IDCT_ROWS)
    out = _post_idct_limit(t)
    return out.transpose(0, 2, 1, 3).reshape(H, W)


def _rgb_to_ycc(px):
    fix = lambda x: int(x * 65536 + 0.5)  # noqa: E731
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


def _ycc_to_rgb(y, cb, cr):
    fix = lambda x: int(x * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    xb, xr = cb - 128, cr - 128
    r = y + ((fix(1.402) * xr + half) >> 16)
    g = y + ((-fix(0.34414) * xb + half - fix(0.71414) * xr) >> 16)
    b = y + ((fix(1.772) * xb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _pad_to(plane, h, w):
    """Edge replication of ``plane`` to (h, w)."""
    return plane[_replicate(plane.shape[0], 0, h)][:, _replicate(plane.shape[1], 0, w)]


def _downsample_h2v2(c, H, W, out_h, out_w):
    """jcsample.c h2v2_downsample of a full-size chroma plane: rows padded
    to an even count and columns to 2 * out_w by replication, 2x2 sums plus
    the bias 1, 2, 1, 2 ... along each row, >> 2; then the rows padded to
    out_h by replicating the last one."""
    rows2 = 2 * (-(-H // 2))
    p = _pad_to(c, rows2, 2 * out_w)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_w) % 2 == 0, 1, 2)
    return _pad_to((s + bias) >> 2, out_h, out_w)


def _upsample_h2v2(c, out_h, out_w):
    """The decoder's h2v2 upsampling of a (ch, cw) chroma plane to (out_h,
    out_w): jdsample.c h2v2_fancy_upsample (3/4 and 1/4 in each dimension,
    the row above or below as context, the first and last rows and columns
    their own neighbours, biases 8 and 7) when cw > 2, else
    h2v2_upsample's pixel replication."""
    ch, cw = c.shape
    if cw <= 2:
        return np.repeat(np.repeat(c, 2, 0), 2, 1)[:out_h, :out_w]
    up = c[np.maximum(np.arange(ch) - 1, 0)]
    down = c[np.minimum(np.arange(ch) + 1, ch - 1)]
    colsum = np.empty((2 * ch, cw), np.int32)
    colsum[0::2] = 3 * c + up
    colsum[1::2] = 3 * c + down
    last = np.concatenate([colsum[:, :1], colsum[:, :-1]], 1)
    nxt = np.concatenate([colsum[:, 1:], colsum[:, -1:]], 1)
    out = np.empty((2 * ch, 2 * cw), np.int32)
    out[:, 0::2] = (3 * colsum + last + 8) >> 4
    out[:, 1::2] = (3 * colsum + nxt + 7) >> 4
    return out[:out_h, :out_w]


@_numpy_io
def jpeg_roundtrip_u8(img: np.ndarray, quality: int) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> the RGB image that ``cv2.imdecode(
    cv2.imencode(".jpg", img[..., ::-1], [IMWRITE_JPEG_QUALITY,
    quality])[1], IMREAD_COLOR)[..., ::-1]`` returns, computed without a
    bitstream: RGB -> YCbCr by libjpeg's 16-bit tables; luma edge-replicated
    to whole 16x16 MCUs; chroma h2v2-downsampled; each plane through the
    islow forward DCT, the reciprocal quantiser, dequantisation and the
    islow inverse DCT with its range limit; chroma upsampled; YCbCr -> RGB
    by the decoder's tables."""
    H, W = img.shape[:2]
    y, cb, cr = _rgb_to_ycc(img.astype(np.int32))
    mh, mw = 16 * (-(-H // 16)), 16 * (-(-W // 16))
    qy, qc = quant_tables(quality)
    y = _code_plane(_pad_to(y, mh, mw), qy)[:H, :W]
    ch, cw = -(-H // 2), -(-W // 2)
    chroma = [
        _upsample_h2v2(_code_plane(_downsample_h2v2(c, H, W, mh // 2, mw // 2), qc)[:ch, :cw], H, W)
        for c in (cb, cr)
    ]
    return _ycc_to_rgb(y, *chroma)


# ----------------------------------------------------------------- fillPoly

_XY_SHIFT = 16


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine(Size2l, Point2l&, Point2l&): Cohen-Sutherland codes,
    y first, with the double arithmetic and truncation of drawing.cpp.
    Returns (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _lines8(x1, y1, x2, y2):
    """Pixels of OpenCV's 8-connected LineIterator(img, pt1, pt2, 8,
    leftToRight=true) for segments inside the image (int64 arrays of
    endpoints): walked from the left end, the minor axis stepping when the
    Bresenham error is negative, so the minor offset after k steps is
    max(0, ceil((2 minor k - major) / (2 major)))."""
    swap = x2 < x1
    x1, y1, x2, y2 = np.where(swap, x2, x1), np.where(swap, y2, y1), np.where(swap, x1, x2), np.where(swap, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    major, minor = np.maximum(dx, dy), np.minimum(dx, dy)
    counts = major + 1
    seg = np.repeat(np.arange(len(x1)), counts)
    k = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts, counts)
    M, m_ = major[seg], minor[seg]
    m = np.where(M > 0, np.maximum(0, -((M - 2 * m_ * k) // np.maximum(2 * M, 1))), 0)
    vert = (dy > dx)[seg]
    return x1[seg] + np.where(vert, m, k), y1[seg] + sy[seg] * np.where(vert, k, m)


def _line8(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """:func:`_lines8` of one segment, clipped to the (w, h) image first as
    LineIterator clips it (nothing when it misses the image)."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _lines8(*(np.asarray([v], np.int64) for v in (x1, y1, x2, y2)))


@_numpy_io
def fill_poly_u8(mask: np.ndarray, polygon, value: int = 1) -> np.ndarray:
    """Fill one polygon ((n, 2) int x, y vertices) into a copy of the (H, W)
    uint8 ``mask``, equal to ``cv2.fillPoly(mask, [polygon], value)`` (shift
    0, LINE_8) of OpenCV 5.0: the outline drawn as 8-connected clipped
    lines; edges in 16-bit fixed point from the vertices (no half-pixel
    offset), an edge that leaves the image taking the x of its clipped ends
    (and their y where the clipped ends differ in y); then the scanline
    fill of :func:`_fill_edges`.  Self-intersecting, repeated-vertex and
    out-of-image polygons follow the same rules.  The edges inside the image
    go through numpy all at once, the others one by one."""
    out = np.array(mask, np.uint8, copy=True)
    fill_poly_into(out, polygon, value)
    return out


def fill_poly_into(out: np.ndarray, polygon, value: int = 1) -> None:
    """:func:`fill_poly_u8` in place on the (H, W) uint8 array ``out``."""
    H, W = out.shape
    pts = np.asarray(polygon, np.int64).reshape(-1, 2)
    X1, Y1 = pts[:, 0], pts[:, 1]
    X0, Y0 = np.roll(X1, 1), np.roll(Y1, 1)  # edge i runs from vertex i - 1 to vertex i
    inside = (X0 >= 0) & (X0 < W) & (X1 >= 0) & (X1 < W) & (Y0 >= 0) & (Y0 < H) & (Y1 >= 0) & (Y1 < H)
    xs, ys = _lines8(X0[inside], Y0[inside], X1[inside], Y1[inside])
    out[ys, xs] = value
    p0x, p1x, p0y, p1y = X0 << _XY_SHIFT, X1 << _XY_SHIFT, Y0.copy(), Y1.copy()
    for i in np.flatnonzero(~inside):
        x0, y0, x1, y1 = int(X0[i]), int(Y0[i]), int(X1[i]), int(Y1[i])
        xs, ys = _line8(W, H, x0, y0, x1, y1)
        out[ys, xs] = value
        _, t0x, t0y, t1x, t1y = _clip_line(W, H, x0, y0, x1, y1)
        p0x[i], p1x[i] = t0x << _XY_SHIFT, t1x << _XY_SHIFT
        if t0y != t1y:
            p0y[i], p1y[i] = t0y, t1y
    keep = Y0 != Y1
    if keep.sum() < 2:
        return
    num, den = (p1x - p0x)[keep], (p1y - p0y)[keep]
    dx = np.abs(num) // np.abs(den) * np.where((num >= 0) == (den >= 0), 1, -1)  # C's truncation
    down = (Y0 < Y1)[keep]
    start = np.where(down, p0x[keep] + (Y0[keep] - p0y[keep]) * dx, p1x[keep] + (Y1[keep] - p1y[keep]) * dx)
    edges = np.stack([np.minimum(Y0, Y1)[keep], np.maximum(Y0, Y1)[keep], start, dx], 1)
    ys, x1s, x2s = _fill_edges(edges, H, W)
    if len(ys):
        # the spans' union over their bounding box: +1 at each start, -1 past
        # each end, a running sum along the rows
        top, left = int(ys.min()), int(x1s.min())
        diff = np.zeros((int(ys.max()) + 1 - top, int(x2s.max()) + 2 - left), np.int32)
        np.add.at(diff, (ys - top, x1s - left), 1)
        np.add.at(diff, (ys - top, x2s + 1 - left), -1)
        box = out[top:top + diff.shape[0], left:left + diff.shape[1] - 1]
        box[np.cumsum(diff, 1)[:, :-1] > 0] = value


def _fill_edges(edges, H: int, W: int):
    """The spans (rows, first and last columns) that FillEdgeCollection
    (drawing.cpp) fills.  It walks a sorted active edge list scanline by
    scanline: an edge is active on rows y0 <= y < y1 at x + (y - y0) * dx;
    the crossings of a row, in x order, pair up, and each pair fills from
    ceil of the lower x to floor of the higher, clipped to the image (a pair
    wholly outside fills nothing).  All rows at once here."""
    e = np.asarray(edges, np.int64)
    ylo, yhi = max(int(e[:, 0].min()), 0), min(int(e[:, 1].max()), H)
    if ylo >= yhi:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    y = np.arange(ylo, yhi, dtype=np.int64)[:, None]
    active = (e[None, :, 0] <= y) & (y < e[None, :, 1])
    big = np.iinfo(np.int64).max
    x = np.where(active, e[None, :, 2] + (y - e[None, :, 0]) * e[None, :, 3], big)
    if x.shape[1] % 2:
        x = np.concatenate([x, np.full((len(y), 1), big)], 1)
    x = np.sort(x, 1)
    pair = np.arange(x.shape[1] // 2)[None] < (active.sum(1) // 2)[:, None]
    x1 = (x[:, 0::2] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    x2 = x[:, 1::2] >> _XY_SHIFT
    draw = pair & (x1 < W) & (x2 >= 0)
    rows = np.broadcast_to(y, x1.shape)[draw]
    return rows, np.maximum(x1[draw], 0), np.minimum(x2[draw], W - 1)


# ------------------------------------------------------ rectangle, ellipse

# OpenCV's SinTable (drawing.cpp): float32 sines of whole degrees 0..450,
# each the sine rounded to 7 decimals
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451, dtype=np.float64))), 7).astype(np.float32)


def fill_rect_into(img: np.ndarray, pt1, pt2, color) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, -1)`` in place on the (H, W, C)
    uint8 ``img``: every pixel from the lower to the higher corner, both
    included, clipped at the image."""
    H, W = img.shape[:2]
    (x1, y1), (x2, y2) = (int(v) for v in pt1), (int(v) for v in pt2)
    x1, x2 = max(min(x1, x2), 0), min(max(x1, x2), W - 1)
    y1, y2 = max(min(y1, y2), 0), min(max(y1, y2), H - 1)
    if x1 <= x2 and y1 <= y2:
        img[y1:y2 + 1, x1:x2 + 1] = color


def ellipse_vertices(center, axes) -> np.ndarray:
    """The (n, 2) int64 vertices, in 16-bit fixed point, of the polygon that
    a filled full ``cv2.ellipse(img, center, axes, 0, 0, 360, ...)`` draws
    (EllipseEx): ``ellipse2Poly``'s points at OpenCV's step for the larger
    axis (90, 30, 18 or 5 degrees), each rounded half to even, repeats in
    a row dropped, a lone point doubled."""
    cx, cy = (int(v) << _XY_SHIFT for v in center)
    aw, ah = (abs(int(v)) << _XY_SHIFT for v in axes)
    big = (max(aw, ah) + (1 << (_XY_SHIFT - 1))) >> _XY_SHIFT
    step = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    angle = np.minimum(np.arange(0, 360 + step, step), 360)
    # x = cx + aw cos - ah sin * 0 with cos, sin of angle 0 from the table:
    # exact in float64, as OpenCV's doubles are
    x = cx + aw * _SIN_TABLE[450 - angle].astype(np.float64)
    y = cy + ah * _SIN_TABLE[angle].astype(np.float64)
    pts = np.stack([np.rint(x), np.rint(y)], 1).astype(np.int64)
    pts = pts[np.r_[True, (pts[1:] != pts[:-1]).any(1)]]
    if len(pts) == 1:
        pts = np.array([[cx, cy], [cx, cy]], np.int64)
    return pts


def _fixed_lines(W: int, H: int, p0: np.ndarray, p1: np.ndarray):
    """Pixels (xs, ys) of OpenCV's Line2 (the 8-connected line between 16-bit
    fixed-point points that FillConvexPoly draws around a shifted polygon)
    for each segment p0[i] -> p1[i], clipped to the image in fixed point:
    the end point rounded, then one pixel a step of the major axis from the
    lower end, the minor coordinate advancing by a truncated fixed-point
    slope."""
    half = 1 << (_XY_SHIFT - 1)
    xs, ys = [], []
    for (ax_, ay_), (bx_, by_) in zip(p0.tolist(), p1.tolist()):
        inside, x1, y1, x2, y2 = _clip_line(W << _XY_SHIFT, H << _XY_SHIFT, ax_, ay_, bx_, by_)
        if not inside:
            continue
        dx, dy = x2 - x1, y2 - y1
        if abs(dx) > abs(dy):
            if dx < 0:
                x1, y1, x2, y2 = x2, y2, x1, y1
                dy = -dy
            step = _tdiv(dy << _XY_SHIFT, abs(dx) | 1)
            count = (x2 - x1) >> _XY_SHIFT
            k = np.arange(count + 1, dtype=np.int64)
            px, py = ((x1 + half) >> _XY_SHIFT) + k, (y1 + half + k * step) >> _XY_SHIFT
        else:
            if dy < 0:
                x1, y1, x2, y2 = x2, y2, x1, y1
                dx = -dx
            step = _tdiv(dx << _XY_SHIFT, abs(dy) | 1)
            count = (y2 - y1) >> _XY_SHIFT
            k = np.arange(count + 1, dtype=np.int64)
            px, py = (x1 + half + k * step) >> _XY_SHIFT, ((y1 + half) >> _XY_SHIFT) + k
        xs += [np.array([(x2 + half) >> _XY_SHIFT]), px]
        ys += [np.array([(y2 + half) >> _XY_SHIFT]), py]
    if not xs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    xs, ys = np.concatenate(xs), np.concatenate(ys)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    return xs[keep], ys[keep]


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex_fixed_into(img: np.ndarray, v: np.ndarray, color) -> None:
    """OpenCV's FillConvexPoly(img, v, n, color, LINE_8, XY_SHIFT) in place:
    the outline by :func:`_fixed_lines`, then from the top vertex down a
    left and a right chain of edges, each edge's x starting at its upper
    vertex's on the row where the chain reaches it and stepping by a rounded
    fixed-point slope, each row filled between the rounded chain x's; the
    walk shares one budget of n vertex visits and stops when it runs out."""
    H, W = img.shape[:2]
    n = len(v)
    half = 1 << (_XY_SHIFT - 1)
    xs, ys = _fixed_lines(W, H, np.roll(v, 1, 0), v)
    img[ys, xs] = color
    xmin, xmax = (int(v[:, 0].min()) + half) >> _XY_SHIFT, (int(v[:, 0].max()) + half) >> _XY_SHIFT
    ymin, ymax = (int(v[:, 1].min()) + half) >> _XY_SHIFT, (int(v[:, 1].max()) + half) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    vx, vy = v[:, 0].tolist(), v[:, 1].tolist()
    imin = int(np.argmin(v[:, 1]))  # the first vertex of the smallest y
    side = [dict(idx=imin, di=1, x=-(1 << _XY_SHIFT), dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-(1 << _XY_SHIFT), dx=0, ye=ymin)]
    budget = n
    rows, lo, hi = [], [], []
    y = ymin
    while y <= ymax:
        for e in side:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while budget > 0:
                budget -= 1
                ty = (vy[idx] + half) >> _XY_SHIFT
                if ty > y:
                    e.update(ye=ty, dx=_tdiv((vx[idx] - vx[idx0]) * 2 + (ty - y), 2 * (ty - y)),
                             x=vx[idx0], idx=idx)
                    break
                idx0, idx = idx, (idx + e["di"]) % n
            else:
                budget = -1
        if budget < 0:
            break
        # rows y .. stop - 1 need no chain update
        stop = min(side[0]["ye"], side[1]["ye"], ymax + 1)
        k = np.arange(stop - y, dtype=np.int64)
        xa, xb = side[0]["x"] + k * side[0]["dx"], side[1]["x"] + k * side[1]["dx"]
        rows.append(y + k)
        lo.append((np.minimum(xa, xb) + half) >> _XY_SHIFT)
        hi.append((np.maximum(xa, xb) + half) >> _XY_SHIFT)
        for e in side:
            e["x"] += (stop - y) * e["dx"]
        y = stop
    if not rows:
        return
    rows, lo, hi = np.concatenate(rows), np.concatenate(lo), np.concatenate(hi)
    draw = (rows >= 0) & (hi >= 0) & (lo < W)
    rows, lo, hi = rows[draw], np.maximum(lo[draw], 0), np.minimum(hi[draw], W - 1)
    if len(rows):
        top, left = int(rows.min()), int(lo.min())
        diff = np.zeros((int(rows.max()) + 1 - top, int(hi.max()) + 2 - left), np.int32)
        np.add.at(diff, (rows - top, lo - left), 1)
        np.add.at(diff, (rows - top, hi + 1 - left), -1)
        box = img[top:top + diff.shape[0], left:left + diff.shape[1] - 1]
        box[np.cumsum(diff, 1)[:, :-1] > 0] = color


def fill_ellipse_into(img: np.ndarray, center, axes, color) -> None:
    """``cv2.ellipse(img, center, axes, 0, 0, 360, color, -1)`` in place on
    the (H, W, C) uint8 ``img``: the polygon of :func:`ellipse_vertices`
    filled by :func:`_fill_convex_fixed_into`."""
    _fill_convex_fixed_into(img, ellipse_vertices(center, axes), color)
