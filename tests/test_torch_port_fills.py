"""``data.cv_ops.fill_rect_into`` and ``fill_ellipse_into`` against OpenCV:
filled ``cv2.rectangle`` and full filled ``cv2.ellipse`` (angle 0, 0-360
degrees, LINE_8) on uint8 images, byte for byte, on 1,000 seeded random
cases (shapes wholly inside, crossing every edge and corner, outside) and on
the edge cases: 0- and 1-pixel axes, 1-pixel images, the step changes of
the ellipse's polygon (at axes 3, 10 and 15), and the sizes of the quality
tools' scenes."""

import numpy as np
import pytest

from salience_detr_torch.data.cv_ops import ellipse_vertices, fill_ellipse_into, fill_rect_into

cv2 = pytest.importorskip("cv2")


def both(img, draw_cv2, draw_port):
    want, got = img.copy(), img.copy()
    draw_cv2(want)
    draw_port(got)
    np.testing.assert_array_equal(got, want)


def random_image(rng, H, W):
    return rng.integers(0, 60, (H, W, 3), dtype=np.uint8)


def color(rng):
    return tuple(int(c) for c in rng.integers(100, 256, 3))


@pytest.mark.parametrize("seed", range(10))
def test_rectangles_match_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        H, W = (int(v) for v in rng.integers(1, 70, 2))
        p1 = tuple(int(v) for v in rng.integers(-30, 100, 2))
        p2 = tuple(int(v) for v in rng.integers(-30, 100, 2))
        c = color(rng)
        both(random_image(rng, H, W), lambda im: cv2.rectangle(im, p1, p2, c, -1),
             lambda im: fill_rect_into(im, p1, p2, c))


@pytest.mark.parametrize("seed", range(10))
def test_ellipses_match_cv2(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(50):
        H, W = (int(v) for v in rng.integers(1, 90, 2))
        center = tuple(int(v) for v in rng.integers(-40, 130, 2))
        axes = tuple(int(v) for v in (rng.integers(0, 4, 2) if rng.random() < 0.3 else rng.integers(0, 70, 2)))
        c = color(rng)
        both(random_image(rng, H, W), lambda im: cv2.ellipse(im, center, axes, 0, 0, 360, c, -1),
             lambda im: fill_ellipse_into(im, center, axes, c))


@pytest.mark.parametrize("where", ["inside", "left", "right", "top", "bottom", "top_left", "top_right",
                                   "bottom_left", "bottom_right", "over_all", "outside"])
def test_shapes_clipped_at_each_edge(where):
    """Rectangles and ellipses, small to larger than the image, placed across
    one edge or corner of a 40x56 image, or over all of it, or beside it."""
    H, W = 40, 56
    cx = {"left": 0, "right": W - 1, "top_left": 0, "bottom_left": 0, "top_right": W - 1, "bottom_right": W - 1}
    cy = {"top": 0, "bottom": H - 1, "top_left": 0, "top_right": 0, "bottom_left": H - 1, "bottom_right": H - 1}
    rng = np.random.default_rng(len(where))
    for r in (1, 2, 3, 9, 10, 14, 15, 30, 80):
        x, y = cx.get(where, W // 2), cy.get(where, H // 2)
        if where == "outside":
            x, y = -r - 2, H + r + 2
        for dx, dy in ((0, 0), (1, -1), (-2, 3)):
            c, center, axes = color(rng), (x + dx, y + dy), (r, max(r // 2, 1))
            both(random_image(rng, H, W), lambda im: cv2.ellipse(im, center, axes, 0, 0, 360, c, -1),
                 lambda im: fill_ellipse_into(im, center, axes, c))
            p1, p2 = (x + dx - r, y + dy - r // 2), (x + dx + r, y + dy + r // 2)
            both(random_image(rng, H, W), lambda im: cv2.rectangle(im, p1, p2, c, -1),
                 lambda im: fill_rect_into(im, p1, p2, c))


@pytest.mark.parametrize("axes", [(0, 0), (1, 0), (0, 1), (1, 1), (1, 2), (2, 1), (2, 2), (1, 7), (7, 1),
                                  (3, 3), (9, 9), (10, 4), (14, 14), (15, 2), (16, 16)])
def test_small_axes_and_the_polygon_steps(axes):
    """Axes of 0-2 pixels and either side of the polygon's step changes,
    every centre of a 20x24 image, and on a 1-pixel image."""
    rng = np.random.default_rng(sum(axes))
    for cy in range(-1, 21, 3):
        for cx in range(-1, 25, 5):
            c = color(rng)
            both(random_image(rng, 20, 24), lambda im: cv2.ellipse(im, (cx, cy), axes, 0, 0, 360, c, -1),
                 lambda im: fill_ellipse_into(im, (cx, cy), axes, c))
    both(random_image(rng, 1, 1), lambda im: cv2.ellipse(im, (0, 0), axes, 0, 0, 360, (255, 0, 9), -1),
         lambda im: fill_ellipse_into(im, (0, 0), axes, (255, 0, 9)))


def test_sine_table_is_opencvs():
    """``ellipse2Poly`` at axes of 2**30 and a 1-degree step returns 2**30
    times each entry of OpenCV's float sine table, exactly."""
    from salience_detr_torch.data.cv_ops import _SIN_TABLE

    pts = cv2.ellipse2Poly((0, 0), (1 << 30, 1 << 30), 0, 0, 360, 1).astype(np.float64)
    angle = np.arange(361)
    np.testing.assert_array_equal(pts[:, 0], np.rint((1 << 30) * _SIN_TABLE[450 - angle].astype(np.float64)))
    np.testing.assert_array_equal(pts[:, 1], np.rint((1 << 30) * _SIN_TABLE[angle].astype(np.float64)))


@pytest.mark.parametrize("axes,step", [((1, 2), 90), ((2, 2), 90), ((3, 1), 30), ((9, 3), 30), ((10, 1), 18),
                                       ((14, 14), 18), ((15, 15), 5), ((320, 40), 5)])
def test_ellipse_polygon_is_opencvs(axes, step):
    """The polygon's fixed-point vertices are ``ellipse2Poly``'s points for
    the axes in 1/65536 pixels at the step OpenCV picks for the larger axis
    (90, 30, 18 or 5 degrees), repeats dropped."""
    want = cv2.ellipse2Poly((0, 0), (axes[0] << 16, axes[1] << 16), 0, 0, 360, step)
    np.testing.assert_array_equal(ellipse_vertices((0, 0), axes), want)


def test_scene_sizes_at_the_full_canvas():
    """Ellipses and rectangles of the campaign's sizes (up to 640 px, centres
    anywhere near an 800x1344 canvas)."""
    rng = np.random.default_rng(7)
    img = np.zeros((800, 1344, 3), np.uint8)
    for _ in range(25):
        center = (int(rng.integers(-200, 1544)), int(rng.integers(-200, 1000)))
        axes = tuple(int(v) for v in rng.integers(1, 640, 2))
        c = color(rng)
        both(img, lambda im: cv2.ellipse(im, center, axes, 0, 0, 360, c, -1),
             lambda im: fill_ellipse_into(im, center, axes, c))
