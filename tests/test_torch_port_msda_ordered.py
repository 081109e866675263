"""A numpy copy of K3's ordered design (``csrc/msda_backward.cu``
``msda_backward_ordered``), step for step at a small size on the CPU: the
entries (in-level corners with a nonzero weight, attn * cw folded at G = H),
their rows (b, s, g), the stable sort by row in passes of one digit (each a
count per tile of consecutive positions, a scan over (digit value, tile)
and a placement in position order), each row's bounds in the sorted
entries, and each row's sum in that order.  The sort leaves every row's
entries in key order, at any digit width and tile size; d_value equals the
plain backward's within K3's float32 tolerance, also where the clustered
points pile hundreds of entries on a row."""

import numpy as np
import pytest
import torch

from salience_detr_torch.ops.deform_attn import ms_deform_attn_backward_plain

TILE, DIGIT_BITS_MAX = 2048, 8  # kTile, kDigitBitsMax


def fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def entries(loc, attn, levels, G, H):
    """(key, row, weight) of every entry, in key order: key = item * 4 +
    corner, item = ((bq * G + g) * L + l) * P + p; row = (b * S + s) * G + g."""
    B, Q, _, L, P, _ = loc.shape
    S = sum(h * w for h, w in levels)
    starts = np.cumsum([0] + [h * w for h, w in levels])
    out = []
    for b in range(B):
        for q in range(Q):
            for g in range(G):
                for lvl, (lh, lw) in enumerate(levels):
                    for p in range(P):
                        item = (((b * Q + q) * G + g) * L + lvl) * P + p
                        # loc * size - 0.5 rounded twice, clamped, floored
                        x = np.float32(np.float32(loc[b, q, g, lvl, p, 0] * np.float32(lw)) - np.float32(0.5))
                        y = np.float32(np.float32(loc[b, q, g, lvl, p, 1] * np.float32(lh)) - np.float32(0.5))
                        x = min(max(x, np.float32(-2)), np.float32(lw + 1))
                        y = min(max(y, np.float32(-2)), np.float32(lh + 1))
                        x0, y0 = np.floor(x), np.floor(y)
                        fx, fy = np.float32(x - x0), np.float32(y - y0)
                        for c in range(4):
                            dy, dx = c >> 1, c & 1
                            cy, cx = int(y0) + dy, int(x0) + dx
                            if not (0 <= cy < lh and 0 <= cx < lw):
                                continue
                            wy = fy if dy else np.float32(1) - fy
                            wx = fx if dx else np.float32(1) - fx
                            cw = np.float32(wx * wy)
                            if G == H:
                                cw = np.float32(attn[b, q, g, lvl, p] * cw)
                            if cw != 0:
                                s = starts[lvl] + cy * lw + cx
                                out.append((item * 4 + c, (b * S + s) * G + g, cw))
    return out


def digit_widths(rows, bits_max):
    """The passes' digit width (plan_workspace): the bits of the largest
    row over as few passes of at most ``bits_max`` bits as take them."""
    bits = 1
    while bits < 31 and (1 << bits) < rows:
        bits += 1
    passes = -(-bits // bits_max)
    return passes, -(-bits // passes)


def sort_pass(rows_in, keys_in, n, shift, width, tile):
    """One pass (msda_digit_count_kernel, the scan, msda_digit_place_kernel):
    the digit values of each tile of ``tile`` consecutive positions counted,
    the exclusive scan over (value, tile), and each tile's entries placed in
    position order.  A row below 0 is no entry; ``keys_in`` None: the key is
    the position."""
    tiles = -(-len(rows_in) // tile)
    mask = (1 << width) - 1
    hist = np.zeros((mask + 1, tiles), np.int64)
    for pos in range(n):
        if rows_in[pos] >= 0:
            hist[(rows_in[pos] >> shift) & mask, pos // tile] += 1
    offs = (np.cumsum(hist.reshape(-1)) - hist.reshape(-1)).reshape(hist.shape)
    total = int(hist.sum())
    rows_out, keys_out = np.full(len(rows_in), -7), np.full(len(rows_in), -7)
    for pos in range(n):
        row = rows_in[pos]
        if row >= 0:
            v = (row >> shift) & mask
            slot = offs[v, pos // tile]
            offs[v, pos // tile] += 1
            rows_out[slot], keys_out[slot] = row, pos if keys_in is None else keys_in[pos]
    return rows_out, keys_out, total


def sorted_entries(row_of, nrows, bits_max=DIGIT_BITS_MAX, tile=TILE):
    """The sort's passes from each key's row: (rows, keys) of the entries."""
    passes, width = digit_widths(nrows, bits_max)
    rows, keys, n = row_of, None, len(row_of)
    for p in range(passes):
        rows, keys, total = sort_pass(rows, keys, n, p * width, width, tile)
        n = total if p == 0 else n
    return rows[:n], keys[:n]


def row_bounds(rows, nrows):
    """msda_row_bounds_kernel: each row's [first, end) in the sorted entries."""
    first, end = np.zeros(nrows, np.int64), np.zeros(nrows, np.int64)
    for i, row in enumerate(rows):
        if i == 0 or rows[i - 1] != row:
            first[row] = i
        if i == len(rows) - 1 or rows[i + 1] != row:
            end[row] = i + 1
    return first, end


def row_sum(keys, weight, row, d_out, attn, G, H, C, L, P):
    """One row's channels (msda_gather_kernel): the entries' sum in the
    order given, one fma a channel an entry."""
    CG, D = C // G, C // H
    g = row % G
    channels = np.arange(g * CG, (g + 1) * CG)
    heads = channels // D
    acc = np.zeros(CG, np.float32)
    for key in keys:
        item = key >> 2
        bq, lp = item // (G * L * P), item % (L * P)
        w = weight[key]
        for i, (c, h) in enumerate(zip(channels, heads)):
            aw = w if G == H else np.float32(attn.reshape(-1, H, L * P)[bq, h, lp] * w)
            if aw != 0:
                acc[i] = fma(aw, d_out.reshape(-1, C)[bq, c], acc[i])
    return acc


def ordered_d_value(value, loc, attn, d_out, levels, bits_max=DIGIT_BITS_MAX, tile=TILE):
    """d_value of the ordered design, and the longest row's entry count."""
    B, S, C = value.shape
    _, Q, G, L, P, _ = loc.shape
    H = attn.shape[2]
    found = entries(loc, attn, levels, G, H)
    weight = {key: w for key, _, w in found}
    row_of = np.full(B * Q * G * L * P * 4, -1)
    for key, row, _ in found:
        row_of[key] = row
    nrows = B * S * G
    rows, keys = sorted_entries(row_of, nrows, bits_max, tile)
    by_row = sorted((row, key) for key, row, _ in found)
    assert [(int(r), int(k)) for r, k in zip(rows, keys)] == by_row  # each row's entries in key order
    first, end = row_bounds(rows, nrows)
    d_value = np.zeros((nrows, C // G), np.float32)
    for row in range(nrows):
        d_value[row] = row_sum(keys[first[row]:end[row]], weight, row, d_out, attn, G, H, C, L, P)
    return d_value.reshape(B, S, C), int((end - first).max())


LEVELS = [(4, 6), (2, 3)]


def inputs(G, clustered, seed=0):
    rng = np.random.default_rng(seed)
    B, Q, H, C, P, L = 2, 70, 4, 16, 2, len(LEVELS)
    S = sum(h * w for h, w in LEVELS)
    value = rng.normal(size=(B, S, C)).astype(np.float32)
    if clustered:  # every point on one pixel centre of each level: one long row a level and image
        loc = np.empty((B, Q, G, L, P, 2), np.float32)
        for lvl, (h, w) in enumerate(LEVELS):
            loc[..., lvl, :, 0], loc[..., lvl, :, 1] = (w // 2 + 0.5) / w, (h // 2 + 0.5) / h
    else:
        loc = (rng.uniform(-0.3, 1.3, (B, Q, G, L, P, 2))).astype(np.float32)
        loc[:, :5] = ((np.floor(loc[:, :5] * 4) + 0.5) / 4).astype(np.float32)  # some on pixel centres: cw = 0
    attn = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    attn[0, 0, :, 0, 0] = 0  # attn * cw = 0 adds nothing
    d_out = rng.normal(size=(B, Q, C)).astype(np.float32)
    return value, loc, attn, d_out


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("clustered", [False, True])
def test_ordered_design_matches_the_plain_backward_in_any_placement(G, clustered):
    """Any digit width and tile size places the entries alike: the same bits."""
    value, loc, attn, d_out = inputs(G, clustered)
    got, longest = ordered_d_value(value, loc, attn, d_out, LEVELS)
    # with one-bit digits and tiles of 32 positions: more passes and tiles, the same bits
    again, _ = ordered_d_value(value, loc, attn, d_out, LEVELS, bits_max=1, tile=32)
    np.testing.assert_array_equal(got, again)
    assert (longest > 128) == clustered
    want = ms_deform_attn_backward_plain(torch.from_numpy(value), LEVELS, torch.from_numpy(loc),
                                         torch.from_numpy(attn), torch.from_numpy(d_out))[0].numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("bits_max, tile", [(DIGIT_BITS_MAX, TILE), (3, 64), (1, 32)])
def test_sort_passes_keep_every_rows_entries_in_key_order(bits_max, tile):
    """The passes on random rows (a third of the keys no entry): the rows
    ascend and each row's keys ascend, whatever the digit width and tile."""
    rng = np.random.default_rng(bits_max)
    row_of = rng.integers(0, 300, 5000)
    row_of[rng.random(5000) < 0.33] = -1
    rows, keys = sorted_entries(row_of, 300, bits_max, tile)
    order = np.lexsort((np.arange(5000), row_of))
    order = order[row_of[order] >= 0]
    np.testing.assert_array_equal(keys, order)
    np.testing.assert_array_equal(rows, row_of[order])
    assert digit_widths(300, bits_max)[0] == -(-9 // bits_max)
