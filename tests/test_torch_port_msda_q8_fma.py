"""Why the int8 MSDA sampler (``csrc/msda_q8.cu``) may fuse its corner
multiply-adds in bf16 output and stay bitwise equal to ``q8_sample_plain``,
and why it keeps the attention-weight product apart: numpy, products taken in
float64 (exact for these operands) and compared with their float32 rounding.

* Every int8 value times every bf16 value in [0, 1] (the corner weights,
  wx * wy rounded to bf16: 16,257 values, 4,161,792 products) is exact in
  float32, also the products below the float32 normal range (multiples of
  2^-133, far above the smallest subnormal 2^-149).  So fmaf(w, v, s) rounds
  once, as the plain version's multiply (exact) then add does.
* A bf16 times a bf16 (the head's attention weight times the bf16-rounded
  corner sum) is exact in float32 wherever the product lies in the normal
  range, but not below it: a seeded sample with the extremes finds inexact
  products there, where a fused multiply-add would round differently from a
  multiply then an add.  The kernel keeps that multiply and add apart.
"""

import numpy as np

F32_TINY = float(np.finfo(np.float32).tiny)  # 2^-126, the smallest normal
F32_MAX = float(np.finfo(np.float32).max)


def bf16_values(bits):
    """bf16 bit patterns (uint16) -> float64 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def exact_in_f32(p):
    with np.errstate(over="ignore"):  # past the float32 range: inf, not exact
        return p.astype(np.float32).astype(np.float64) == p


def test_int8_times_unit_bf16_is_exact_in_float32():
    w = bf16_values(np.arange(0, 0x3F81))  # +0 ... 1.0, subnormals included
    assert w.min() == 0.0 and w.max() == 1.0 and len(w) == 16257
    v = np.arange(-128, 128, dtype=np.float64)
    p = w[:, None] * v[None, :]
    assert p.size == 4161792
    exact = exact_in_f32(p)
    below = (p != 0) & (np.abs(p) < F32_TINY)
    assert below.sum() == 1274, "the sweep reaches below the normal range"
    assert exact.all(), f"{(~exact).sum()} inexact products, {(~exact & below).sum()} of them below 2^-126"


def test_bf16_times_bf16_is_exact_only_in_the_normal_range():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, size=(2, 2_000_000), dtype=np.uint32)
    finite = ((bits >> 7) & 0xFF) != 0xFF
    a, b = bf16_values(bits[0][finite[0] & finite[1]]), bf16_values(bits[1][finite[0] & finite[1]])
    # the extremes: 0, the smallest and largest subnormals, the smallest
    # normal, 1 and its neighbours, the largest finite value, both signs
    extremes = bf16_values([0x0000, 0x0001, 0x007F, 0x0080, 0x00C0, 0x3F7F, 0x3F80, 0x3F81, 0x7F7F,
                            0x8001, 0x8080, 0xBF80, 0xFF7F, 0x3A81, 0x3581, 0x4300])
    a = np.concatenate([a, np.repeat(extremes, len(extremes))])
    b = np.concatenate([b, np.tile(extremes, len(extremes))])
    p = a * b
    in_range = np.abs(p) <= F32_MAX
    normal = in_range & (np.abs(p) >= F32_TINY)
    below = (p != 0) & (np.abs(p) < F32_TINY)
    exact = exact_in_f32(p)
    assert normal.sum() > 500000 and below.sum() > 100000
    assert exact[normal].all(), f"{(~exact & normal).sum()} inexact products in the normal range"
    # below the normal range some products lose bits: where the kernel may
    # not fuse the multiply and the add
    inexact_below = int((~exact & below).sum())
    assert inexact_below > 0 and not (~exact & in_range & ~below & (p != 0)).any()
    # one of them: the smallest bf16 subnormal times 1.0078125 * 2^-20
    small = bf16_values([0x0001])[0] * bf16_values([0x3581])[0]
    assert not exact_in_f32(np.array([small]))[0]
