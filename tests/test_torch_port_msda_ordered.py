"""A numpy copy of K3's ordered design (``csrc/msda_backward.cu``
``msda_backward_ordered``), step for step at a small size on the CPU: the
entries (in-level corners with a nonzero weight, attn * cw folded at G = H),
their rows (b, s, g), the stable sort by row in passes of one digit (each a
count per tile of consecutive positions, a scan over (digit value, tile)
and a placement in position order), the digit width and tile taken from the
row count, each row's bounds written by the last pass's placement, the
gather's blocks (tokens coarsest level first, in raster order), and each
row's sum in key order.  The sort leaves every row's entries in key order,
at any digit width and tile size; d_value equals the plain backward's within
K3's float32 tolerance, also where the clustered points pile hundreds of
entries on a row, and the blocks' order of the rows changes no bit of it."""

import numpy as np
import pytest
import torch

from salience_detr_torch.ops.deform_attn import ms_deform_attn_backward_plain

TILE, DIGIT_BITS_MAX = 2048, 8  # kTile, kDigitBitsMax
SORT_THREADS = 256  # kSortThreads
GATHER_WARPS = 8  # kGatherWarps


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


def sort_pass(rows_in, keys_in, n, shift, width, tile, bounds=None):
    """One pass (msda_digit_count_kernel, the scan, msda_digit_place_kernel):
    the digit values of each tile of ``tile`` consecutive positions counted,
    the exclusive scan over (value, tile), and each tile's entries placed in
    position order.  A row below 0 is no entry; ``keys_in`` None: the key is
    the position.  ``bounds`` (first, end), the last pass: each tile's staged
    entries, in (value, position) order, give the first and last slot of
    each run of one row to first (min) and end (max)."""
    tiles = -(-len(rows_in) // tile)
    mask = (1 << width) - 1
    hist = np.zeros((mask + 1, tiles), np.int64)
    for pos in range(n):
        if rows_in[pos] >= 0:
            hist[(rows_in[pos] >> shift) & mask, pos // tile] += 1
    offs = (np.cumsum(hist.reshape(-1)) - hist.reshape(-1)).reshape(hist.shape)
    total = int(hist.sum())
    rows_out, keys_out = np.full(len(rows_in), -7), np.full(len(rows_in), -7)
    for t in range(tiles):
        live = [pos for pos in range(t * tile, min((t + 1) * tile, n)) if rows_in[pos] >= 0]
        staged = sorted(live, key=lambda pos: (rows_in[pos] >> shift) & mask)  # stable: position order
        for i, pos in enumerate(staged):
            row = rows_in[pos]
            v = (row >> shift) & mask
            slot = offs[v, t]
            offs[v, t] += 1
            rows_out[slot], keys_out[slot] = row, pos if keys_in is None else keys_in[pos]
            if bounds is not None:
                first, end = bounds
                if i == 0 or rows_in[staged[i - 1]] != row:
                    first[row] = min(first[row], slot)
                if i + 1 == len(staged) or rows_in[staged[i + 1]] != row:
                    end[row] = max(end[row], slot + 1)
    return rows_out, keys_out, total


def sorted_entries(row_of, nrows, bits_max=DIGIT_BITS_MAX, tile=TILE):
    """The sort's passes from each key's row: (rows, keys) of the entries
    and the rows' (first, end) written by the last pass (first 2^32 - 1 and
    end 0 for a row with none)."""
    passes, width = digit_widths(nrows, bits_max)
    rows, keys, n = row_of, None, len(row_of)
    bounds = np.full(nrows, 2**32 - 1, np.int64), np.zeros(nrows, np.int64)
    for p in range(passes):
        rows, keys, total = sort_pass(rows, keys, n, p * width, width, tile,
                                      bounds if p + 1 == passes else None)
        n = total if p == 0 else n
    return rows[:n], keys[:n], bounds


def row_bounds(rows, nrows):
    """msda_row_bounds_kernel: each row's [first, end) in the sorted entries."""
    first, end = np.zeros(nrows, np.int64), np.zeros(nrows, np.int64)
    for i, row in enumerate(rows):
        if i == 0 or rows[i - 1] != row:
            first[row] = i
        if i == len(rows) - 1 or rows[i + 1] != row:
            end[row] = i + 1
    return first, end


def attn_side_by_side(attn, G):
    """make_entries' copy of attn at G < H: item (b, q, g, l, p)'s H / G
    heads side by side, flat (item * H / G + head in the group)."""
    B, Q, H, L, P = attn.shape
    return attn.reshape(B, Q, G, H // G, L, P).transpose(0, 1, 2, 4, 5, 3).reshape(-1)


def row_sum(keys, weight, row, d_out, attn, G, H, C, L, P):
    """One row's channels (msda_gather_kernel): the entries' sum in the
    order given, one fma a channel an entry; at G < H each entry's attn
    read from the entry pass's side-by-side copy."""
    CG, D = C // G, C // H
    g = row % G
    channels = np.arange(g * CG, (g + 1) * CG)
    heads = channels // D
    attn_t = attn_side_by_side(attn, G)
    acc = np.zeros(CG, np.float32)
    for key in keys:
        item = key >> 2
        bq, lp = item // (G * L * P), item % (L * P)
        w = weight[key]
        for i, (c, h) in enumerate(zip(channels, heads)):
            aw = w if G == H else np.float32(attn_t[item * (H // G) + h % (H // G)] * w)
            assert G == H or attn_t[item * (H // G) + h % (H // G)] == attn.reshape(-1, H, L * P)[bq, h, lp]
            if aw != 0:
                acc[i] = fma(aw, d_out.reshape(-1, C)[bq, c], acc[i])
    return acc


def gather_rows(levels, B, C, H, G):
    """msda_gather_kernel's blocks: for each block in launch order, the rows
    its teams sum (lanes past the tokens sum none), and the block count
    dispatch_gather launches.  Tokens are taken coarsest level first, then
    image by image, in raster order; a block the next GATHER_WARPS warps'
    tokens."""
    D, CG = C // H, C // G
    cpl = min(8, D)
    lpr_log2, g_log2 = (CG // cpl).bit_length() - 1, G.bit_length() - 1
    assert lpr_log2 + g_log2 <= 5 and cpl << lpr_log2 == CG
    tpw_log2 = 5 - lpr_log2 - g_log2
    S = sum(h * w for h, w in levels)
    starts = np.cumsum([0] + [h * w for h, w in levels])
    teams = [(warp, lane >> lpr_log2) for warp in range(GATHER_WARPS) for lane in range(0, 32, 1 << lpr_log2)]
    order = [(b, starts[lvl] + i) for lvl in reversed(range(len(levels))) for b in range(B)
             for i in range(levels[lvl][0] * levels[lvl][1])]
    per_block = GATHER_WARPS << tpw_log2
    blocks = []
    for blk in range(-(-len(order) // per_block)):
        rows = []
        for warp, r in teams:
            t = ((blk * GATHER_WARPS + warp) << tpw_log2) + r // G
            if t < len(order):
                b, tok = order[t]
                rows.append((b * S + tok) * G + r % G)
        blocks.append(rows)
    return blocks, -(-B * S // per_block)


def ordered_d_value(value, loc, attn, d_out, levels, bits_max=DIGIT_BITS_MAX, tile=TILE, blocks=False):
    """d_value of the ordered design, and the longest row's entry count;
    ``blocks``: the rows summed in the gather's block order."""
    B, S, C = value.shape
    _, Q, G, L, P, _ = loc.shape
    H = attn.shape[2]
    found = entries(loc, attn, levels, G, H)
    weight = {key: w for key, _, w in found}
    row_of = np.full(B * Q * G * L * P * 4, -1)
    for key, row, _ in found:
        row_of[key] = row
    nrows = B * S * G
    rows, keys, (first, end) = sorted_entries(row_of, nrows, bits_max, tile)
    by_row = sorted((row, key) for key, row, _ in found)
    assert [(int(r), int(k)) for r, k in zip(rows, keys)] == by_row  # each row's entries in key order
    want_first, want_end = row_bounds(rows, nrows)
    empty = want_end == want_first
    np.testing.assert_array_equal(end, want_end)  # the last pass's bounds
    np.testing.assert_array_equal(first[~empty], want_first[~empty])
    assert (first[empty] > end[empty]).all()
    order = [row for block in gather_rows(levels, B, C, H, G)[0] for row in block] if blocks else range(nrows)
    d_value = np.zeros((nrows, C // G), np.float32)
    for row in order:
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
    again, _ = ordered_d_value(value, loc, attn, d_out, LEVELS, bits_max=1, tile=32, blocks=True)
    np.testing.assert_array_equal(got, again)
    assert (longest > 128) == clustered
    want = ms_deform_attn_backward_plain(torch.from_numpy(value), LEVELS, torch.from_numpy(loc),
                                         torch.from_numpy(attn), torch.from_numpy(d_out))[0].numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("bits_max, tile", [(8, 2048), (3, 64), (1, 32)])
def test_sort_passes_keep_every_rows_entries_in_key_order(bits_max, tile):
    """The passes on random rows (a third of the keys no entry): the rows
    ascend and each row's keys ascend, whatever the digit width and tile,
    and the last pass's bounds are each row's range."""
    rng = np.random.default_rng(bits_max)
    row_of = rng.integers(0, 300, 5000)
    row_of[rng.random(5000) < 0.33] = -1
    rows, keys, (first, end) = sorted_entries(row_of, 300, bits_max, tile)
    order = np.lexsort((np.arange(5000), row_of))
    order = order[row_of[order] >= 0]
    np.testing.assert_array_equal(keys, order)
    np.testing.assert_array_equal(rows, row_of[order])
    assert digit_widths(300, bits_max)[0] == -(-9 // bits_max)
    want_first, want_end = row_bounds(rows, 300)
    np.testing.assert_array_equal(first, want_first)
    np.testing.assert_array_equal(end, want_end)


# rows B * S * G of the ported train steps' K3 calls (B = 4): the flagship
# encoder (S = 22,323, G = 1), its decoder and Swin-L's exact encoder (G = 8),
# the 5-scale config's exact encoder (S = 89,250, G = 8)
PORTED_ROWS = {"flagship encoder": (89_292, 17), "flagship decoder": (714_336, 20),
               "5-scale encoder": (2_856_000, 22)}


@pytest.mark.parametrize("shape", sorted(PORTED_ROWS))
def test_digit_plan_at_the_ported_shapes(shape):
    """17-, 20- and 22-bit row counts sort in three passes of 6-, 7- and
    8-bit digits; the place kernel's shared memory (the warps' counts, two
    offsets a digit value, the staged (row, key) pairs) fits a block's 48
    KB of static shared memory, and the counts (a digit value and tile)
    stay an eighth of the keys.  (Two passes would take 9- to 11-bit
    digits, whose tiles of 4096 to 16384 positions keep the counts an
    eighth of the keys but keep fewer blocks on an SM: every such pass cost
    more on the card than the pass it saved, PERF.md.)"""
    rows, bits = PORTED_ROWS[shape]
    passes, width = digit_widths(rows, DIGIT_BITS_MAX)
    assert (passes, width) == (3, -(-bits // 3))
    assert 4 * (SORT_THREADS // 32 + 2) * (1 << width) + 8 * TILE <= 48 * 1024
    assert (1 << width) * 8 <= TILE
    assert digit_widths(rows, 11)[0] == 2


@pytest.mark.parametrize("C, H, G", [(16, 4, 1), (16, 4, 4), (256, 8, 1), (256, 8, 8), (32, 8, 2)])
def test_gather_blocks_cover_every_row_once_coarsest_first(C, H, G):
    """The gather's blocks take every row exactly once, the coarsest level's
    tokens first, in as many blocks as the host launches; a warp sums whole
    tokens' rows (one token at C = 256)."""
    levels = [(9, 13), (5, 7), (3, 4), (1, 2)]
    B, S = 2, sum(h * w for h, w in levels)
    token_level = np.repeat(np.arange(len(levels)), [h * w for h, w in levels])
    blocks, launched = gather_rows(levels, B, C, H, G)
    assert len(blocks) == launched
    assert sorted(row for block in blocks for row in block) == list(range(B * S * G))
    row_levels = [token_level[(row // G) % S] for block in blocks for row in block]
    assert row_levels == sorted(row_levels, reverse=True)
    if C == 256:  # a warp one token's G rows
        assert max(len(block) for block in blocks) == GATHER_WARPS * G
        assert all(len({row // G for row in block[i:i + G]}) == 1 for block in blocks for i in range(0, len(block), G))
