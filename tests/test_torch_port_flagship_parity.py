"""The flagship at full width and depth against the JAX model (ROADMAP Queue
A item 3; marked ``slow``: the JAX forward of the whole R50 detector
compiles for minutes on a CPU).

Setup: the flagship config (R50 FrozenBN, embed 256, 8 heads, 4 x 4 points,
6 + 6 layers, 900 queries, head-shared encoder, exact decoder), float32 on
the CPU, seeded random JAX variables carried into the port by
``state_dict_from_jax`` (strict load), a batch of 2 numpy images on the
128 x 352 canvas, the second padded to 100 x 301.

The canvas is the smallest (sides multiples of 32) whose four levels (16 x
44, 8 x 22, 4 x 11, 2 x 6: 936 tokens) give the two-stage selection its
full 900 proposals: top-k = min(4 x 900, 936) = 936 candidates, of which
fewer than 900 survive the grid NMS, so the suppressed ones backfill (the
test counts the survivors).  Every level's budget (``max(int(tokens x
ratio), 1)``, ratios 0.4 / 0.8 / 1.0 / 1.0) is its ratio's share, not the
floor of 1.

Checked: the salience maps at rtol 1e-3 / atol 1e-3 (the full-model
tolerance); per image the proposal top-k set and the NMS output exactly,
the top-k order exactly but for neighbours whose scores lie within
ORDER_ULPS float32 ulps in both packages, and where the NMS output agrees
the selected proposals' logits and boxes and every decoder layer's class
logits and boxes at the same tolerance.  Where an index parts beyond that,
the test fails, and its message shows the first parting rank, the two
tokens' scores in both packages and their gaps.

Why the order may part between near-ties: the two packages' float32 sums
part from the backbone's first normalisation on (``tests/flagship_parity_walk.py``
walks the forward).  The stem convolution agrees bitwise; the FrozenBatchNorm
after it does not, because XLA:CPU contracts its ``x * w + b`` into one fused
multiply-add and rounds its ``rsqrt`` otherwise (42% of its outputs), and
the first 3x3 convolution, the LayerNorms and the Linear heads part on
identical inputs by oneDNN's and MKL's order of sums against XLA:CPU's
(88%, 65% and 92% of their outputs).  By the proposal scores the gap is a
median of 4 and at most 29 ulps a token, so two tokens a few ulps apart may
rank either way.  The one such pair, the second image's tokens 332 and 121
at rank 533 of 936, lies 5 ulps apart in the port at the two torch threads
this test pins (2.27335238 / 2.27335119; 2 ulps at 8 threads, whose sums run
in another order) and 3 in JAX (2.27335072 / 2.27335143).  ORDER_ULPS is the
larger measured gap."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks import salience_transformer as jax_st
from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.bricks import salience_transformer as port_st
from salience_detr_torch.models.factory import build_salience_detr
from salience_detr_torch.weights import state_dict_from_jax
from tests.torch_port_common import jax_variable_shapes, random_variables, t
from tests.torch_port_common import two_torch_threads  # noqa: F401 (an autouse fixture: the port's sums follow the thread count)

CANVAS = (128, 352)
PADDED = (100, 301)
RTOL, ATOL = 1e-3, 1e-3
ORDER_ULPS = 5  # the measured gap of the one near-tie that ranks the other way (module docstring)


def grid_survivors(topk_index, levels):
    """How many of the ranked candidates the greedy 4-neighbour grid NMS
    keeps (numpy, rank by rank)."""
    starts = np.cumsum([0] + [h * w for h, w in levels])
    kept = set()
    for token in map(int, topk_index):
        lvl = int(np.searchsorted(starts, token, side="right")) - 1
        h, w = levels[lvl]
        y, x = divmod(token - int(starts[lvl]), w)
        neighbours = [(y + dy, x + dx) for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0))]
        if not any(0 <= ny < h and 0 <= nx < w and int(starts[lvl]) + ny * w + nx in kept for ny, nx in neighbours):
            kept.add(token)
    return len(kept)


def parted(name, got, want, port_scores, jax_scores):
    """An assertion message for index arrays that differ: the first parting
    rank, the two tokens and their scores in both packages, and the gap."""
    i = int(np.flatnonzero(got != want)[0])
    a, b = int(got[i]), int(want[i])
    return (f"{name} parts at rank {i}: port token {a}, JAX token {b}; port scores {port_scores[a]:.9g} / "
            f"{port_scores[b]:.9g} (gap {port_scores[a] - port_scores[b]:.3e}), JAX scores {jax_scores[a]:.9g} / "
            f"{jax_scores[b]:.9g} (gap {jax_scores[a] - jax_scores[b]:.3e})")


def order_partings(got, want, port_scores, jax_scores, ulps=ORDER_ULPS):
    """The pairs of tokens that the two rankings order differently and
    whose scores are more than ``ulps`` float32 ulps apart in either
    package, as (port rank, port rank) pairs of ``got``."""
    jax_rank = np.empty(int(max(want.max(), got.max())) + 1, np.int64)
    jax_rank[want] = np.arange(len(want))
    r = jax_rank[got]
    i, j = np.nonzero(np.triu(r[:, None] > r[None, :], 1))  # i before j in the port, after it in JAX

    def apart(scores):
        a, b = scores[got[i]].astype(np.float32), scores[got[j]].astype(np.float32)
        return np.abs(a.astype(np.float64) - b) > ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))

    far = apart(port_scores) | apart(jax_scores)
    return list(zip(i[far].tolist(), j[far].tolist()))


@pytest.mark.slow
def test_flagship_full_width_and_depth_matches_jax(monkeypatch):
    cfg = dataclasses.replace(load_config(DEFAULT_CONFIG), dtype=torch.float32)
    jmodel, *_ = build_jax(JaxConfig(shared_sampling_locations=True, decoder_sampling_groups=0))
    variables = random_variables(jax_variable_shapes(jmodel, canvas=(64, 64)), seed=20)
    tmodel, _ = build_salience_detr(cfg, torch.device("cpu"))
    tmodel.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)

    B, (H, W) = 2, CANVAS
    levels = [(math.ceil(H / s), math.ceil(W / s)) for s in (8, 16, 32, 64)]
    S = sum(h * w for h, w in levels)
    assert levels == [(16, 44), (8, 22), (4, 11), (2, 6)] and S == 936
    assert [max(int(h * w * r), 1) for (h, w), r in zip(levels, cfg.level_filter_ratio)] == [281, 140, 44, 12]
    rng = np.random.default_rng(21)
    images = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    sizes = np.asarray([[H, W], list(PADDED)], np.int32)

    jax_nms = []
    real_jax_nms = jax_st.grid_nms_topk

    def recording_jax_nms(topk_index, shapes, num_out):
        out = real_jax_nms(topk_index, shapes, num_out)
        jax.debug.callback(lambda a, b: jax_nms.append((np.asarray(a), np.asarray(b))), topk_index, out)
        return out

    monkeypatch.setattr(jax_st, "grid_nms_topk", recording_jax_nms)
    want, state = jax.jit(lambda v, x, s: jmodel.apply(
        v, x, s, train=False, capture_intermediates=lambda m, _: m.name == "encoder_class_head",
        mutable=["intermediates"]))(variables, jnp.asarray(images), jnp.asarray(sizes))
    jax.effects_barrier()
    jax_class = [np.asarray(o) for o in jax.tree.leaves(state["intermediates"]) if o.shape[1:] == (S, 91)]
    assert len(jax_class) == 1
    jax_scores = jax_class[0].max(-1)

    port_nms, port_class = [], []
    real_port_nms = port_st.grid_nms_topk

    def recording_port_nms(topk_index, shapes, num_out):
        out = real_port_nms(topk_index, shapes, num_out)
        port_nms.append((topk_index.numpy().copy(), out.numpy().copy()))
        return out

    monkeypatch.setattr(port_st, "grid_nms_topk", recording_port_nms)
    hook = tmodel.transformer.encoder_class_head.register_forward_hook(
        lambda m, i, o: port_class.append(o.detach().numpy().copy()))
    with torch.no_grad():
        got = tmodel(t(images).permute(0, 3, 1, 2).contiguous(), t(sizes).long())
    hook.remove()
    port_scores = [c for c in port_class if c.shape[1:] == (S, 91)][0].max(-1)

    (port_topk, port_out), = port_nms
    assert port_topk.shape == (B, S) and port_out.shape == (B, 900)
    np.testing.assert_array_equal(got["proposal_index"].numpy(), port_out)
    assert len(jax_nms) == B
    for lvl, s in enumerate(want["salience"]):
        np.testing.assert_allclose(got["salience"][lvl].numpy(), np.asarray(s), rtol=RTOL, atol=ATOL,
                                   err_msg=f"salience level {lvl}")
    # each image's indices, then its proposals' and decoder's outputs where
    # its NMS output agrees (the proposals are the decoder's queries); every
    # parting is reported at the end
    partings = []
    for b in range(B):
        # the vmapped JAX callbacks arrive in no fixed image order: pair by the top-k
        jax_topk, jax_out = max(jax_nms, key=lambda p: int((p[0] == port_topk[b]).sum()))
        assert grid_survivors(jax_topk, levels) < 900  # the NMS backfills
        if set(port_topk[b].tolist()) != set(jax_topk.tolist()):
            partings.append(f"image {b} proposal top-k sets differ")
        elif order_partings(port_topk[b], jax_topk, port_scores[b], jax_scores[b]):
            partings.append(parted(f"image {b} proposal top-k", port_topk[b], jax_topk, port_scores[b],
                                   jax_scores[b]))
        if not np.array_equal(port_out[b], jax_out):
            partings.append(parted(f"image {b} NMS", port_out[b], jax_out, port_scores[b], jax_scores[b]))
            continue
        for key in ("enc_class", "enc_coord", "pred_class", "pred_coord"):
            g, w = got[key].numpy(), np.asarray(want[key])
            image = (slice(None), b) if key.startswith("pred") else (b,)  # pred_*: (layers, B, Q, ...)
            np.testing.assert_allclose(g[image], w[image], rtol=RTOL, atol=ATOL, err_msg=f"image {b} {key}")
    assert not partings, "; ".join(partings)
