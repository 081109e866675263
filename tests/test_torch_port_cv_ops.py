"""The port's cv2-free image operations (salience_detr_torch/data/cv_ops.py)
against cv2 itself: HSV both ways on all 2^24 uint8 triples (rows of
several widths, so both OpenCV's vector blocks and its scalar row tails are
held), the 3x3 box and median filters, the JPEG round trip byte for byte
at the qualities RandomJPEG draws from, polygon filling on random,
self-intersecting, collinear, repeated-vertex and out-of-image polygons,
the nearest-neighbour mask resize, all exactly, and the Gaussian blur of
copy-paste's alpha within 1e-6."""

import numpy as np
import pytest
import torch

from salience_detr_torch.data import cv_ops
from tests.torch_port_common import two_torch_threads  # noqa: F401

cv2 = pytest.importorskip("cv2")

ALL = np.arange(1 << 24, dtype=np.uint32)


def all_triples(start, stop):
    px = ALL[start:stop]
    return np.stack([(px >> 16) & 255, (px >> 8) & 255, px & 255], -1).astype(np.uint8)


@pytest.mark.parametrize("chunk", range(4))
def test_rgb2hsv_all_inputs(chunk):
    n = 1 << 22
    img = all_triples(chunk * n, (chunk + 1) * n).reshape(-1, 1024, 3)
    np.testing.assert_array_equal(cv_ops.rgb2hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("chunk", range(4))
def test_hsv2rgb_all_inputs(chunk):
    """Each chunk as rows of one width: 1024 (vector blocks only), 1000 and
    1 (the scalar tail), 33."""
    n = 1 << 22
    width = (1024, 1000, 1, 33)[chunk]
    px = all_triples(chunk * n, (chunk + 1) * n)
    img = px[: len(px) // width * width].reshape(-1, width, 3)
    np.testing.assert_array_equal(cv_ops.hsv2rgb_u8(img), cv2.cvtColor(img, cv2.COLOR_HSV2RGB))


def test_hsv2rgb_rows_cover_every_input():
    """The chunks above leave the tail of the 1000- and 33-wide chunks: the
    remaining triples in rows of width 7."""
    n = 1 << 22
    rest = [all_triples(c * n, (c + 1) * n) for c in (1, 3)]
    rest = np.concatenate([r[len(r) // w * w:] for r, w in zip(rest, (1000, 33))])
    img = rest[: len(rest) // 7 * 7].reshape(-1, 7, 3)
    np.testing.assert_array_equal(cv_ops.hsv2rgb_u8(img), cv2.cvtColor(img, cv2.COLOR_HSV2RGB))
    img = rest[len(rest) // 7 * 7:][None]
    if img.size:
        np.testing.assert_array_equal(cv_ops.hsv2rgb_u8(img), cv2.cvtColor(img, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 2), (3, 3), (5, 7), (64, 65), (480, 640)])
@pytest.mark.parametrize("channels", [None, 3])
def test_box_and_median_filters(shape, channels):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    img = rng.integers(0, 256, shape if channels is None else shape + (channels,), dtype=np.uint8)
    np.testing.assert_array_equal(cv_ops.box3_u8(img), cv2.blur(img, (3, 3)))
    np.testing.assert_array_equal(cv_ops.median3_u8(img), cv2.medianBlur(img, 3))


def jpeg_images(h, w, rng):
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                       (xx + yy) * 127 // max(h + w - 2, 1)], -1).astype(np.uint8)
    edge = np.where(((xx // 5 + yy // 7) % 2)[..., None] == 0, np.array([250, 10, 30]), np.array([5, 240, 200]))
    return {"noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "smooth": smooth,
            "edge": edge.astype(np.uint8)}


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (2, 3), (480, 640), (427, 640)])
def test_jpeg_roundtrip_is_byte_equal(size):
    rng = np.random.default_rng(size[0] * 7 + size[1])
    for name, img in jpeg_images(*size, rng).items():
        for q in (85, 90, 95):
            ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])
            assert ok
            want = cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1]
            got = cv_ops.jpeg_roundtrip_u8(img, q)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert np.array_equal(got, want), (name, q, int((got != want).any(-1).sum()))


def test_quant_tables_match_libjpeg_scaling():
    luma, chroma = cv_ops.quant_tables(50)
    assert luma[0] == 16 and chroma[0] == 17  # quality 50 is the standard tables
    luma, chroma = cv_ops.quant_tables(95)
    assert luma.min() >= 1 and luma.max() <= 255 and luma[0] == 2


POLYGON_KINDS = {
    "random": lambda rng, h, w: np.stack([rng.integers(0, w, n := int(rng.integers(3, 12))),
                                          rng.integers(0, h, n)], 1),
    "self_intersecting": lambda rng, h, w: np.asarray([[5, 5], [w - 5, h - 5], [w - 5, 5], [5, h - 5]])
    + rng.integers(-3, 4, (4, 2)),
    "collinear": lambda rng, h, w: np.stack([np.arange(5) * 3, np.arange(5) * 2], 1) + rng.integers(0, 10, 2),
    "repeated_vertex": lambda rng, h, w: np.repeat(rng.integers(-5, w + 5, (int(rng.integers(2, 6)), 2)),
                                                   int(rng.integers(1, 3)), axis=0),
    "out_of_image": lambda rng, h, w: rng.integers(-40, w + 40, (int(rng.integers(3, 12)), 2)),
    "far_out": lambda rng, h, w: rng.integers(-1000, 1000, (int(rng.integers(3, 8)), 2)),
    "one_or_two_points": lambda rng, h, w: rng.integers(0, w, (int(rng.integers(1, 3)), 2)),
}


@pytest.mark.parametrize("kind", sorted(POLYGON_KINDS))
def test_fill_poly_equals_cv2(kind):
    rng = np.random.default_rng(len(kind))
    for _ in range(300):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 90))
        pts = POLYGON_KINDS[kind](rng, h, w).astype(np.int32)
        mask = (rng.random((h, w)) < 0.05).astype(np.uint8)
        want = cv2.fillPoly(mask.copy(), [pts], 1)
        got = cv_ops.fill_poly_u8(mask, pts, 1)
        assert np.array_equal(got, want), (h, w, pts.tolist())


@pytest.mark.parametrize("case", [(10, 10, 7, 13), (480, 640, 800, 1066), (427, 640, 600, 899),
                                  (3, 5, 1, 1), (100, 100, 333, 17), (1, 1, 4, 3)])
@pytest.mark.parametrize("n", [1, 3, 40])
def test_nearest_resize_of_mask_stacks(case, n):
    h, w, nh, nw = case
    masks = np.random.default_rng(n).integers(0, 2, (h, w, n), dtype=np.uint8)
    want = cv2.resize(masks, (nw, nh), interpolation=cv2.INTER_NEAREST)
    got = cv_ops.resize_nearest_u8(masks, nh, nw)
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 5), (64, 80), (480, 640)])
def test_gaussian_blur_within_1e6(shape):
    alpha = (np.random.default_rng(shape[0]).random(shape) > 0.5).astype(np.float32)
    got = cv_ops.gaussian_blur5_f32(alpha, 2.0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.GaussianBlur(alpha, (5, 5), 2.0), rtol=0, atol=1e-6)


def test_tensors_in_tensors_out():
    img = torch.randint(0, 256, (9, 11, 3), dtype=torch.uint8)
    out = cv_ops.box3_u8(img)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), cv2.blur(img.numpy(), (3, 3)))
    np.testing.assert_array_equal(cv_ops.jpeg_roundtrip_u8(img, 90).numpy(), cv_ops.jpeg_roundtrip_u8(img.numpy(), 90))
