"""Port of the staged MSDA shootout vs the JAX tools, on the CPU.

Every Pallas kernel of tools/ runs here in interpret mode: P2 and P4/P5
through the tool's own functions (``bench_msda2.INTERPRET``), P3 through
``bench_msda3.make_reduce`` with ``pl.pallas_call`` made to interpret, and
the local kernels P1 (bench_gather.py ``gather_c``), P6 (bench_msda5.py
``main.kern``) and P7 (``extra_probes.kern2d``) through
``pl.pallas_call(interpret=True)`` at their BlockSpecs, P6 with the tool's
``_make_nat_kernel`` and P1/P7 from copies of their bodies.  On CPU tensors
the port's wrappers run their plain versions, the specs of the CUDA kernels
K5-K8.  The tools' module shapes are monkeypatched to B=2 and tiny levels
(every h, w >= 2, as the quad layout needs), keeping C=256 and H=8.

Tolerances: f32 outputs rtol 1e-5 / atol 1e-6 (the same bf16 inputs, f32
sums in another order); bf16 outputs within one bf16 ulp of the larger
magnitude, plus the f32 bound (both round an f32 sum once); indices exactly
and weights to f32 rounding (rtol 1e-6); whole pipelines within
``bench_msda2.check``'s bound (rtol 0.05, atol 0.02) against the JAX
pipelines and against ``ms_deform_attn_core_shared``, and the f32 pipelines
also within rtol 1e-4 / atol 1e-5 of their JAX twins (f32 sums in another
order, then an f32 einsum).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.bench_msda2 as m2
import tools.bench_msda3 as m3
from salience_detr_tpu.ops.deform_attn import ms_deform_attn_core_shared
from salience_detr_torch import native
from salience_detr_torch.ops import msda_stages as st
from salience_detr_torch.tools import msda_stages as tool

LEVELS = [(6, 9), (3, 5), (2, 3), (2, 2)]
S = sum(h * w for h, w in LEVELS)
B, Q, C, H, L, P = 2, 20, 256, 8, 4, 4
D = C // H
F32 = dict(rtol=1e-5, atol=1e-6)
CHECK = dict(rtol=0.05, atol=0.02)


@pytest.fixture
def small(monkeypatch):
    """bench_msda2's module shapes at B=2 over LEVELS, kernels interpreted."""
    monkeypatch.setattr(m2, "B", B)
    monkeypatch.setattr(m2, "SHAPES", LEVELS)
    monkeypatch.setattr(m2, "S", S)
    monkeypatch.setattr(m2, "INTERPRET", True)


def bf16_values(rng, shape):
    """Normal values rounded to bf16, as f32 numpy (exact in both packages)."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16().float().numpy()


def inputs(seed, q=Q, edges=False):
    """The shootout's inputs (bench_msda2.make_inputs) from numpy; with
    ``edges`` a few points sit on the level borders and pixel centres."""
    rng = np.random.default_rng(seed)
    value = bf16_values(rng, (B, S, C))
    locs = rng.uniform(0.02, 0.98, (B, q, L, P, 2)).astype(np.float32)
    if edges:
        locs[:, 0, :, 0] = 0.0
        locs[:, 1, :, 1] = 1.0
        locs[:, 2, :, 2] = 0.5
    w = rng.uniform(size=(B, q, H, L, P)).astype(np.float32)
    return value, locs, w / w.sum(axis=(-2, -1), keepdims=True)


def jb(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def tb(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


def tf(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def reduce_weights(rng, n, K):
    """(n, I, K*H) weights as the pipelines give them: positive, each head's
    summing to 1 over the items and sub-rows."""
    wt = rng.uniform(size=(n, L * P, K, H)).astype(np.float32)
    return (wt / wt.sum(axis=(1, 2), keepdims=True)).reshape(n, L * P, K * H)


def assert_f32(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32), **(tol or F32))


def assert_bf16(got, want):
    """Within one bf16 ulp (2**-8 relative to the larger magnitude's binade
    top, so at most 2**-7 of it) plus the f32 bound."""
    got = np.asarray(got.float(), np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + F32["atol"]
    worst = float(np.max(np.abs(got - want) - bound))
    assert worst <= 0, f"bf16 outputs differ by more than one ulp (excess {worst:.3e})"


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize("seed", [0, 1])
def test_corner_indices_and_weights_match_jax(small, seed):
    _, locs, w = inputs(seed, edges=True)
    for name in ("corners_flat", "corners_pmajor"):
        want_idx, want_w = getattr(m2, name)(jnp.asarray(locs))
        got_idx, got_w = getattr(st, name)(tf(locs), LEVELS)
        assert got_idx.dtype == torch.int32 and got_idx.shape == want_idx.shape, name
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx), err_msg=name)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=0, err_msg=name)
    want_base, want_wt = m2.quad_base_and_weights(jnp.asarray(locs), jnp.asarray(w))
    got_base, got_wt = st.quad_base_and_weights(tf(locs), tf(w), LEVELS)
    np.testing.assert_array_equal(got_base.numpy(), np.asarray(want_base))
    np.testing.assert_allclose(got_wt.numpy(), np.asarray(want_wt), rtol=1e-6, atol=0)


@pytest.mark.parametrize("blk", [16, 512])
def test_corner_blocked_matches_jax(small, blk):
    _, locs, _ = inputs(2, edges=True)
    want = m2._corner_blocked(jnp.asarray(locs), blk)
    got = st.corner_blocked(tf(locs), LEVELS, blk)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=0)
    assert got[2:] == (want[2], want[3]) == (B * Q * L * P, (-B * Q * L * P) % blk)


def test_build_quad_matches_jax(small):
    value, _, _ = inputs(3)
    np.testing.assert_array_equal(
        st.build_quad(tb(value), LEVELS).float().numpy(),
        np.asarray(m2.build_quad(jb(value)).astype(jnp.float32)),
    )


def test_make_inputs_layout():
    value, locs, w = st.make_inputs(7, LEVELS, B=3, generator=torch.Generator().manual_seed(0))
    assert value.dtype == torch.bfloat16 and tuple(value.shape) == (3, S, C)
    assert tuple(locs.shape) == (3, 7, L, P, 2) and 0.02 <= float(locs.min()) <= float(locs.max()) <= 0.98
    assert tuple(w.shape) == (3, 7, H, L, P)
    torch.testing.assert_close(w.sum((-2, -1)), torch.ones(3, 7, H))


# ---------------------------------------------------------------- P2, P3: K6


@pytest.mark.parametrize("n", [64, 45])
def test_weighted_reduce_matches_pallas_reduce(small, n):
    """P2 (bench_msda2.pallas_reduce, QT=32); the port takes any N, the
    Pallas kernel a padded one."""
    rng = np.random.default_rng(4)
    g = bf16_values(rng, (64, L * P, 4 * C))
    wt = reduce_weights(rng, 64, 4)
    want = m2.pallas_reduce(jb(g), jnp.asarray(wt), 4)
    got = st.weighted_reduce(tb(g[:n]), tf(wt[:n]), 4)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, C)
    assert_f32(got, np.asarray(want)[:n])


@pytest.mark.parametrize("qt,wdtype", [(32, "float32"), (64, "float32"), (64, "bfloat16")])
def test_weighted_reduce_matches_make_reduce(monkeypatch, qt, wdtype):
    """P3 (the ``run`` that bench_msda3.make_reduce(QT, I, K, wdtype) returns) with K = P = 4 and
    f32 or bf16 weights (the expansion matrix then bf16 as well)."""
    monkeypatch.setattr(m3.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(5)
    g = bf16_values(rng, (128, L * P, 4 * C))
    wt = reduce_weights(rng, 128, 4)
    dt = getattr(jnp, wdtype)
    want = m3.make_reduce(qt, L * P, 4, dt)(jb(g), jnp.asarray(wt).astype(dt), m2._expansion(4).astype(dt))
    weights = tf(wt) if wdtype == "float32" else tb(wt)
    assert_f32(st.weighted_reduce(tb(g), weights, 4), want)


# ---------------------------------------------------------------- P4, P5: K7, K8


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_corner_collapse_blocked_matches_pl_blk_sampled(small, out):
    """P4 (bench_msda2._pl_blk_sampled, blk=512): 640 items, so the last
    group is 384 items of padding, which the port does not compute."""
    value, locs, _ = inputs(6)
    want = m2._pl_blk_sampled(jb(value), jnp.asarray(locs), getattr(jnp, out), blk=512)
    got = tool._blk_sampled(tb(value), LEVELS, tf(locs), getattr(torch, out))
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (B * Q * L * P, C)
    got = got.reshape(B, Q, L, P, C)
    assert_f32(got, want) if out == "float32" else assert_bf16(got, want)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_corner_collapse_packed_matches_pl_nat_sampled(small, out):
    """P5 (bench_msda2._pl_nat_sampled, blk=512); the port needs no padding."""
    value, locs, _ = inputs(7)
    want = m2._pl_nat_sampled(jb(value), jnp.asarray(locs), getattr(jnp, out), blk=512)
    got = tool._nat_sampled(tb(value), LEVELS, tf(locs), getattr(torch, out)).reshape(B, Q, L, P, C)
    assert got.dtype == getattr(torch, out)
    assert_f32(got, want) if out == "float32" else assert_bf16(got, want)


@pytest.mark.parametrize("blk", [512, 2048])
def test_corner_collapse_packed_matches_kern(blk):
    """P6 (bench_msda5.py main.kern: _make_nat_kernel at (1, blk, 4C) blocks,
    bf16 out) on pre-gathered rows; 600 items, the rest of the block padding."""
    rng = np.random.default_rng(8)
    n = 600
    G = -(-n // blk)
    g = np.zeros((G * blk, 4 * C), np.float32)
    g[:n] = bf16_values(rng, (n, 4 * C))
    cw = np.zeros((G * blk, 4), np.float32)
    cw[:n] = rng.uniform(size=(n, 4))
    want = pl.pallas_call(
        m2._make_nat_kernel(blk),
        grid=(G,),
        in_specs=[
            pl.BlockSpec((1, blk, 4 * C), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, blk, 4), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, blk, C), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((G, blk, C), jnp.bfloat16),
        interpret=True,
    )(jb(g).reshape(G, blk, 4 * C), jnp.asarray(cw).reshape(G, blk, 4))
    got = st.corner_collapse_packed(tb(g[:n]), tf(cw[:n]), torch.bfloat16)
    assert_bf16(got, np.asarray(want.astype(jnp.float32)).reshape(-1, C)[:n])


def test_corner_collapse_packed_matches_kern2d():
    """P7 (bench_msda5.py extra_probes.kern2d: 2-D (blk, 4C) blocks, bf16
    weights widened to f32, bf16 out; the body below is a copy of its
    local kernel)."""
    blk, n = 1024, 1500
    G = -(-n // blk)

    def body(g_ref, w_ref, o_ref):
        g = g_ref[:]
        w4 = w_ref[:].astype(jnp.float32)
        acc = g[:, 0:C].astype(jnp.float32) * w4[:, 0:1]
        acc += g[:, C : 2 * C].astype(jnp.float32) * w4[:, 1:2]
        acc += g[:, 2 * C : 3 * C].astype(jnp.float32) * w4[:, 2:3]
        acc += g[:, 3 * C : 4 * C].astype(jnp.float32) * w4[:, 3:4]
        o_ref[:] = acc.astype(o_ref.dtype)

    rng = np.random.default_rng(9)
    g = np.zeros((G * blk, 4 * C), np.float32)
    g[:n] = bf16_values(rng, (n, 4 * C))
    cw = np.zeros((G * blk, 4), np.float32)
    cw[:n] = bf16_values(rng, (n, 4))
    want = pl.pallas_call(
        body,
        grid=(G,),
        in_specs=[
            pl.BlockSpec((blk, 4 * C), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((blk, 4), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((blk, C), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((G * blk, C), jnp.bfloat16),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("arbitrary",)),
        interpret=True,
    )(jb(g), jb(cw))
    got = st.corner_collapse_packed(tb(g[:n]), tb(cw[:n]), torch.bfloat16)
    assert_bf16(got, np.asarray(want.astype(jnp.float32))[:n])


# ---------------------------------------------------------------- P1: K5


def test_gather_sum_matches_gather_c():
    """P1 (bench_gather.py gather_c: one (b, h) value slice per block, QT
    queries of G gathered rows summed; the body below is a copy of its local
    kernel, at QT=8 with Q=20 padded to 24 by index 0)."""
    QT, G = 8, 64
    QPAD = -(-Q // QT) * QT

    def kernel(v_ref, i_ref, o_ref):
        v = v_ref[0, 0]  # (S, D)
        ix = i_ref[0, 0]  # (QT, G)
        g = jnp.take(v, ix.reshape(-1), axis=0)  # (QT*G, D)
        o_ref[0, 0] = g.reshape(QT, G, D).sum(axis=1)

    rng = np.random.default_rng(10)
    value = bf16_values(rng, (B, S, H, D))
    idx = rng.integers(0, S, (B, Q, H, G)).astype(np.int32)
    idx_p = np.pad(np.transpose(idx, (0, 2, 1, 3)), ((0, 0), (0, 0), (0, QPAD - Q), (0, 0)))
    want = pl.pallas_call(
        kernel,
        grid=(B, H, QPAD // QT),
        in_specs=[
            pl.BlockSpec((1, 1, S, D), lambda b, h, q: (b, h, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, QT, G), lambda b, h, q: (b, h, q, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 1, QT, D), lambda b, h, q: (b, h, q, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, H, QPAD, D), jnp.bfloat16),
        interpret=True,
    )(jnp.swapaxes(jb(value), 1, 2), jnp.asarray(idx_p))
    got = tool.gather_c(tb(value), torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, Q, D)
    assert_bf16(got, np.asarray(want.astype(jnp.float32))[:, :, :Q])


# ---------------------------------------------------------------- whole pipelines


@pytest.mark.parametrize("name", ["quad_pl", "flat_pl", "pl_blk", "pl_blk_bf16", "pl_nat", "pl_nat_bf16"])
def test_pipeline_matches_jax(small, name):
    """Each pipeline against its JAX twin (Pallas kernels interpreted) and,
    like bench_msda2.check, against the fused JAX core."""
    value, locs, w = inputs(11)
    jargs = (jb(value), jnp.asarray(locs), jnp.asarray(w))
    want = np.asarray(getattr(m2, name)(*jargs), np.float32)
    core = np.asarray(ms_deform_attn_core_shared(jargs[0], LEVELS, jargs[1], jargs[2], H).astype(jnp.float32))
    got = tool.PIPELINES[name](tb(value), LEVELS, tf(locs), tf(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, Q, C)
    assert_f32(got, want, **(CHECK if name.endswith("bf16") else dict(rtol=1e-4, atol=1e-5)))
    assert_f32(got, core, **CHECK)


def test_bf16_weight_pipeline_matches_jax_core():
    """pl_nat_bf16w (the pipeline of P7) has no JAX pipeline; against the
    fused JAX core within the check's bound."""
    value, locs, w = inputs(12)
    core = ms_deform_attn_core_shared(jb(value), LEVELS, jnp.asarray(locs), jnp.asarray(w), H)
    got = tool.pl_nat_bf16w(tb(value), LEVELS, tf(locs), tf(w))
    assert_f32(got, np.asarray(core.astype(jnp.float32)), **CHECK)


@pytest.mark.parametrize("name", sorted(tool.PIPELINES))
def test_pipeline_check_on_cpu(name):
    """The CLI's check (against ms_deform_attn_plain) passes on the CPU."""
    gen = torch.Generator().manual_seed(1)
    ok, err = tool.check(tool.PIPELINES[name], LEVELS, Q=16, batch=2, generator=gen)
    assert ok and err < CHECK["atol"], err


# ---------------------------------------------------------------- wrappers and CLI


def test_cpu_wrappers_run_plain_versions():
    rng = np.random.default_rng(13)
    g = tb(bf16_values(rng, (5, 3, 2 * C)))
    wt = tf(rng.normal(size=(5, 3, 2 * H)))
    rows = tb(bf16_values(rng, (2, 4 * 8, C)))
    cw = tf(rng.uniform(size=(2, 4 * 8)))
    packed = tb(bf16_values(rng, (7, 4 * C)))
    pw = tf(rng.uniform(size=(7, 4)))
    value = tb(bf16_values(rng, (2, S, H, D)))
    idx = torch.from_numpy(rng.integers(0, S, (2, H, 3, 5)).astype(np.int32))
    before = dict(native.LAUNCHES)
    pairs = [
        (st.gather_sum(value, idx), st.gather_sum_plain(value, idx)),
        (st.weighted_reduce(g, wt, 2), st.weighted_reduce_plain(g, wt, 2)),
        (st.corner_collapse_blocked(rows, cw, 13, torch.bfloat16),
         st.corner_collapse_blocked_plain(rows, cw, 13, torch.bfloat16)),
        (st.corner_collapse_packed(packed, pw, torch.float32),
         st.corner_collapse_packed_plain(packed, pw, torch.float32)),
    ]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert native.LAUNCHES == before
    assert tuple(pairs[2][0].shape) == (13, C)


def test_wrappers_raise_without_a_kernel_for_the_device():
    meta = torch.empty(4, 1, 4 * C, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError):
        st.weighted_reduce(meta, torch.empty(4, 1, 4 * H, device="meta"), 4)
    with pytest.raises(RuntimeError):
        st.corner_collapse_packed(meta[:, 0], torch.empty(4, 4, device="meta"), torch.float32)


def test_cli_exits_nonzero_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tool.main(["--q", "64", "--iters", "1"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
